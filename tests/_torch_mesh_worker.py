"""One rank of the port's mesh tests, run as a process by
tests/test_torch_mesh_*.py and tests/test_torch_examples.py:

    python tests/_torch_mesh_worker.py JOB DIR

with the PIO_TPU_* variables of its rank set. It joins the group on the
CPU, runs ``JOB`` on the inputs the test wrote to ``DIR`` (``in.npz``
and ``in.json``) and writes what it computed to ``DIR/rank<r>.npz``:

 * ``collectives`` — the mesh's layout and its psum on every axis, ring
   and ulysses attention (forward and the gradients of sum(o**2)), and
   ``moe_ffn_ep`` with its refusals;
 * ``sequence`` — ``train_sequence_model`` over each case's mesh, its
   first step's summed gradients, its loss and params, and the
   refusals; step checkpoints from every rank (one writer, resume);
 * ``twotower`` — ``train_two_tower`` over a data x model mesh;
 * ``example`` — ``run_train`` of an engine directory on a data x seq
   context, as the reference's sequence-custom test trains it.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.parallel import distributed
from pio_tpu_torch.parallel.mesh import MeshConfig, create_mesh

def _refusal(fn) -> str:
    """The message of the ValueError ``fn`` raises ("" if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def collectives(inp: dict, spec: dict) -> dict:
    from pio_tpu_torch.ops import attention as attn
    from pio_tpu_torch.ops import moe

    world = torch.distributed.get_world_size()
    got = {}
    # layout: each axis's index and a psum of the rank over each line
    for shape in spec["layouts"]:
        mesh = create_mesh(MeshConfig(*shape), device="cpu")
        name = "x".join(map(str, shape))
        got[f"layout/{name}/coords"] = np.asarray(mesh.coords)
        r = torch.tensor([float(mesh.rank)])
        for axes in (("data",), ("seq",), ("model",), ("data", "seq"),
                     ("seq", "model"), None):
            key = "+".join(axes) if axes else "all"
            got[f"layout/{name}/psum/{key}"] = mesh.psum(r, axes).numpy()
            got[f"layout/{name}/gather/{key}"] = mesh.all_gather(
                r, axes).numpy()
    # sequence-parallel attention over every rank on the seq axis
    mesh = create_mesh(MeshConfig(data=1, seq=world), device="cpu")
    i, n = mesh.axis_index("seq"), world
    q, k, v = (torch.from_numpy(inp[x]) for x in ("q", "k", "v"))
    s = q.shape[1] // n
    for causal in (False, True):
        got[f"ring_sharded/{causal}"] = attn.ring_attention_sharded(
            q, k, v, mesh, "seq", causal=causal).numpy()
        for name, fn in (("ring", attn.ring_attention),
                         ("ulysses", attn.ulysses_attention)):
            if name == "ulysses" and q.shape[2] % n:
                continue
            local = [x[:, i * s:(i + 1) * s].clone().requires_grad_()
                     for x in (q, k, v)]
            o = fn(*local, mesh, "seq", causal=causal)
            (o ** 2).sum().backward()
            got[f"{name}/{causal}/out"] = o.detach().numpy()
            for x, t in zip("qkv", local):
                got[f"{name}/{causal}/d{x}"] = t.grad.numpy()
    # the expert-parallel MoE FFN over every rank on the data axis
    dmesh = create_mesh(MeshConfig(data=world), device="cpu")
    cfg = moe.MoEConfig(**spec["moe"])
    params = {k_: torch.from_numpy(inp[f"moe/{k_}"])
              for k_ in ("router", "w_in", "b_in", "w_out", "b_out")}
    x = torch.from_numpy(inp["moe/x"])
    y, aux = moe.moe_ffn_ep(params, x, cfg, dmesh, axis="data")
    got["moe/y"], got["moe/aux"] = y.numpy(), aux.numpy()
    bad = moe.MoEConfig(**{**spec["moe"], "n_experts": world + 1})
    bad_params = {k_: v_ if k_ == "router" else v_.new_zeros(
        (world + 1, *v_.shape[1:])) for k_, v_ in params.items()}
    bad_params["router"] = params["router"].new_zeros(
        (x.shape[1], world + 1))
    got["moe/refuse_experts"] = np.asarray(_refusal(
        lambda: moe.moe_ffn_ep(bad_params, x, bad, dmesh)))
    got["moe/refuse_tokens"] = np.asarray(_refusal(
        lambda: moe.moe_ffn_ep(params, x[:-1], cfg, dmesh)))
    return got


def _sequence_case(case: dict, inp: dict):
    from pio_tpu_torch.data.bimap import EntityIdIndex
    from pio_tpu_torch.models import sequence as seq

    name = case["name"]
    seqs = inp[f"{name}/seqs"]
    data = seq.SequenceData(seqs, EntityIdIndex(
        f"u{n}" for n in range(len(seqs))), EntityIdIndex(
        f"i{n}" for n in range(case["n_items"])))
    p = seq.SequenceParams(**case["params"])
    init = {k[len(name) + 6:]: inp[k] for k in inp
            if k.startswith(f"{name}/init/")}
    return data, p, init or None


def sequence(inp: dict, spec: dict) -> dict:
    from pio_tpu_torch.models import sequence as seq
    from pio_tpu_torch.workflow.step_checkpoint import (
        StepCheckpointConfig,
        StepCheckpointer,
    )

    got = {}
    for case in spec["cases"]:
        name = case["name"]
        mesh = create_mesh(MeshConfig(*case["mesh"]), device="cpu")
        data, p, init = _sequence_case(case, inp)
        first = {}
        plain_sum = seq.sum_grads

        def keep_first(params, mesh, axis):
            # the first step's gradients, once summed over the ranks
            plain_sum(params, mesh, axis)
            if not first:
                first.update({id(q): q.grad.clone() for q in params})

        seq.sum_grads = keep_first
        try:
            params, encoder, loss = seq.train_sequence_model(
                data, p, device="cpu", init=init, mesh=mesh)
        finally:
            seq.sum_grads = plain_sum
        got[f"{name}/loss"] = np.asarray(loss)
        for k, v in params.items():
            got[f"{name}/params/{k}"] = v.numpy()
        for k, q in encoder.named_parameters():
            got[f"{name}/grads/{k}"] = first[id(q)].numpy()
    for case in spec.get("refusals", ()):
        mesh = create_mesh(MeshConfig(*case["mesh"]), device="cpu")
        data, p, init = _sequence_case(case, inp)
        got[f"refuse/{case['name']}"] = np.asarray(_refusal(
            lambda: seq.train_sequence_model(data, p, device="cpu",
                                             mesh=mesh)))
    from pio_tpu_torch.workflow import step_checkpoint

    writes = []
    plain_write = step_checkpoint.durable_write
    step_checkpoint.durable_write = lambda path, data: (
        writes.append(path), plain_write(path, data))[-1]
    for case in spec.get("checkpoints", ()):
        # the same run uninterrupted, then stopped after a save and resumed
        name = case["name"]
        mesh = create_mesh(MeshConfig(*case["mesh"]), device="cpu")
        data, p, init = _sequence_case(case, inp)
        root = Path(case["dir"])
        runs = {}
        for run, stop in (("whole", p.steps), ("cut", case["stop"]),
                          ("resumed", p.steps)):
            d = root / ("whole" if run == "whole" else "cut")
            with StepCheckpointer(StepCheckpointConfig(
                    str(d), save_every=case["every"])) as ck:
                params, _, loss = seq.train_sequence_model(
                    data, dataclasses.replace(p, steps=stop),
                    device="cpu", init=init, mesh=mesh, checkpoint=ck)
            distributed.barrier("ckpt-run")
            runs[run] = (params, loss)
            got[f"{name}/{run}/files"] = np.asarray(sorted(os.listdir(d)))
        for run, (params, loss) in runs.items():
            got[f"{name}/{run}/loss"] = np.asarray(loss)
            for k, v in params.items():
                got[f"{name}/{run}/params/{k}"] = v.numpy()
        got[f"{name}/writes"] = np.asarray(len(writes))
    return got


def twotower(inp: dict, spec: dict) -> dict:
    from pio_tpu_torch.data.bimap import EntityIdIndex
    from pio_tpu_torch.data.eventstore import Interactions
    from pio_tpu_torch.models import twotower as tt
    from pio_tpu_torch.workflow.step_checkpoint import (
        StepCheckpointConfig,
        StepCheckpointer,
    )

    got = {}
    mesh = create_mesh(MeshConfig(*spec["mesh"]), device="cpu")
    inter = Interactions(
        inp["u"], inp["i"], np.ones(len(inp["u"]), np.float32),
        EntityIdIndex(f"u{n}" for n in range(spec["n_users"])),
        EntityIdIndex(f"i{n}" for n in range(spec["n_items"])))
    init = {k[5:]: inp[k] for k in inp if k.startswith("init/")}
    p = tt.TwoTowerParams(**spec["params"])
    params, item_emb, _, losses = tt.train_two_tower(
        inter, p, device="cpu", init=init, mesh=mesh)
    got["losses"], got["item_emb"] = losses, item_emb.numpy()
    for k, v in params.items():
        got[f"params/{k}"] = v.numpy()
    if "checkpoint" in spec:
        ck = spec["checkpoint"]
        root = Path(ck["dir"])
        for run, stop in (("cut", ck["stop"]), ("resumed", p.steps)):
            with StepCheckpointer(StepCheckpointConfig(
                    str(root), save_every=ck["every"])) as c:
                params, _, _, _ = tt.train_two_tower(
                    inter, dataclasses.replace(p, steps=stop),
                    device="cpu", init=init, mesh=mesh, checkpoint=c)
            distributed.barrier("ckpt-run")
        got["resumed/files"] = np.asarray(sorted(os.listdir(root)))
        for k, v in params.items():
            got[f"resumed/params/{k}"] = v.numpy()
    return got


def example(inp: dict, spec: dict) -> dict:
    from pio_tpu_torch.__main__ import _engine_from_variant, _load_variant
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.train import run_train

    storage = Storage()   # the PIO_STORAGE_* variables of the test's store
    ctx = create_workflow_context(
        storage, device="cpu", mesh_config=MeshConfig(*spec["mesh"]))
    d = spec["engine_dir"]
    engine, ep = _engine_from_variant(_load_variant(d), d)
    iid = run_train(engine, ep, storage, engine_id=spec["engine_id"],
                    ctx=ctx)
    storage.close()
    return {"instance": np.asarray(iid), "mesh": np.asarray(
        [ctx.mesh.shape[a] for a in ("data", "seq", "model")])}


JOBS = {"collectives": collectives, "sequence": sequence,
        "twotower": twotower, "example": example}


def main(job: str, d: str) -> int:
    d = Path(d)
    spec = json.loads((d / "in.json").read_text())
    with np.load(d / "in.npz") as f:
        inp = dict(f)
    distributed.initialize_distributed(device="cpu")
    got = JOBS[job](inp, spec)
    rank = torch.distributed.get_rank()
    distributed.barrier("worker-done")
    np.savez(d / f"rank{rank}.npz", **got)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
