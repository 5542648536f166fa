"""The sequence template's dp x sp training across gloo ranks on the CPU
(``train_sequence_model(..., mesh=)``), against the JAX package's
``train_sequence_model`` on a mesh of the same shape over the 8 CPU
devices that tests/conftest.py gives it.

Both start from the reference's initial params (carried across by
``convert.sequence_params_from_numpy``) and see the same batch stream.
Cases: data 2 x seq 2 with ring attention (4 ranks), data 1 x seq 2 with
ulysses and data 2 x seq 1 with flash (K8's plain version on the CPU;
2 ranks), and the MoE blocks on data 2 x seq 2. Each is held to the
reference on its first step's summed gradients, which carry the
reference's factor n_data * n_seq (its ``psum`` inside the loss is
transposed to another ``psum`` under ``shard_map(check_vma=False)``), on
the final loss and on the final params. Then the refusals, step
checkpoints written from two ranks (one writer; the resumed run equals
the uninterrupted one), and the train verb on two processes, whose
batch is the reference's rounded to the data axis (the divergence of the
one-device trainer this repairs).
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import dataclasses
import json
import os
import re
import textwrap
from datetime import datetime, timedelta, timezone
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from _torch_dist import TESTS, run_ranks
from pio_tpu.models import sequence as ref
from pio_tpu.ops import attention as ref_attn
from pio_tpu.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    MeshConfig,
    create_mesh as ref_mesh,
)
from pio_tpu_torch.convert import (
    _BLOCK_DENSE,
    _BLOCK_MOE,
    _BLOCK_NORM,
    sequence_params_from_numpy,
)
from pio_tpu_torch.models import sequence as port

SMALL = dict(max_len=16, embed_dim=32, num_heads=2, num_layers=2,
             ffn_dim=64, batch_size=16, learning_rate=2e-3)
STEPS = 12
CASES = {
    # name: (mesh (data, seq, model), params)
    "ring": ((2, 2, 1), dict(SMALL, steps=STEPS)),
    "ulysses": ((1, 2, 1), dict(SMALL, steps=STEPS, attention="ulysses")),
    "flash": ((2, 1, 1), dict(SMALL, steps=STEPS, attention="flash")),
    "moe": ((2, 2, 1), dict(SMALL, steps=STEPS, moe_experts=4,
                            num_layers=1)),
}
WORLD = {2: ("ulysses", "flash"), 4: ("ring", "moe")}
# the first step's summed gradients, relative to the largest: the same
# f32 sums in other orders and groupings (measured below 1e-6)
GRAD_RTOL = 1e-5
# the loss after STEPS Adam steps from the same params and batches
# (tests/test_torch_sequence.py's LOSS_RTOL)
LOSS_RTOL = 1e-5
# the params after STEPS Adam steps: Adam's normalized update carries the
# two frameworks' gradient rounding into the params (measured below 1e-5)
PARAM_ATOL = 5e-5
# the MoE blocks: the reference's contract, same ballpark
# (tests/test_sequence.py:174-189)
MOE_LOSS_ATOL = 0.05


class _Ev:
    def __init__(self, u, i, t):
        self.entity_id = u
        self.target_entity_id = i
        self.event_time = t


def _random_events(seed=1, n_users=48, n_items=30):
    rng = np.random.default_rng(seed)
    return [_Ev(f"u{u}", f"i{int(rng.integers(0, n_items))}",
                int(rng.integers(0, 5)))
            for u in range(n_users) for _ in range(int(rng.integers(2, 20)))]


def _data(max_len=16):
    return ref.SequenceData(*ref.build_sequences(_random_events(), max_len))


def _ref_init(n_items, p):
    enc = ref.make_encoder(n_items, p)
    return jax.device_get(enc.init(
        jax.random.PRNGKey(p.seed), jnp.zeros((1, p.max_len - 1), jnp.int32),
        partial(ref_attn.attention_reference, causal=True))["params"])


def _ref_first_grads(data, p, mesh, init):
    """The reference's first step's gradients on ``mesh``: its
    shard_map'd loss and psum (pio_tpu/models/sequence.py:359-417), up to
    the optimizer update."""
    encoder = ref.make_encoder(len(data.items), p)
    inp_all, tgt_all = data.seqs[:, :-1], data.seqs[:, 1:]
    n_data, n_seq = mesh.shape[DATA_AXIS], mesh.shape[SEQ_AXIS]
    s_global = inp_all.shape[1]
    if s_global % n_seq:
        pad = n_seq - s_global % n_seq
        inp_all = np.pad(inp_all, ((0, 0), (0, pad)))
        tgt_all = np.pad(tgt_all, ((0, 0), (0, pad)))
        s_global += pad
    s_local = s_global // n_seq
    if n_seq > 1:
        fn = (ref_attn.ulysses_attention if p.attention == "ulysses"
              else ref_attn.ring_attention)
        attn = partial(fn, axis_name=SEQ_AXIS, causal=True)
    elif p.attention == "flash":
        attn = partial(ref_attn.flash_attention_trainable, causal=True)
    else:
        attn = partial(ref_attn.attention_reference, causal=True)

    def local_loss(params, inp, tgt, pos_offset):
        (_, logits), aux = ref._apply_with_aux(encoder, params, inp, attn,
                                               pos_offset, p)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
        mask = (tgt != 0).astype(jnp.float32)
        loss_sum = jax.lax.psum(jnp.sum(ce * mask), (DATA_AXIS, SEQ_AXIS))
        count = jax.lax.psum(jnp.sum(mask), (DATA_AXIS, SEQ_AXIS))
        aux = jax.lax.pmean(aux, (DATA_AXIS, SEQ_AXIS))
        return loss_sum / jnp.maximum(count, 1.0) + aux

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(DATA_AXIS, SEQ_AXIS), P(DATA_AXIS, SEQ_AXIS)),
             out_specs=P(), check_vma=False)
    def grads(params, inp, tgt):
        pos_offset = jax.lax.axis_index(SEQ_AXIS) * s_local
        g = jax.grad(local_loss)(params, inp, tgt, pos_offset)
        return jax.lax.psum(g, (DATA_AXIS, SEQ_AXIS))

    batch = max(n_data, p.batch_size - p.batch_size % n_data)
    n = inp_all.shape[0]
    size = min(batch, max(8, n))
    size = max(n_data, size - size % n_data)
    idx = np.random.default_rng((p.seed, 0)).integers(0, n, size=size)
    return jax.device_get(jax.jit(grads)(init, jnp.asarray(inp_all[idx]),
                                         jnp.asarray(tgt_all[idx])))


def _single_grads(data, p, init):
    """The one-device gradient of the first step, for the factor."""
    encoder = ref.make_encoder(len(data.items), p)
    inp_all, tgt_all = data.seqs[:, :-1], data.seqs[:, 1:]
    n = inp_all.shape[0]
    idx = np.random.default_rng((p.seed, 0)).integers(
        0, n, size=min(p.batch_size, max(8, n)))

    def loss(params):
        (_, logits), aux = ref._apply_with_aux(
            encoder, params, jnp.asarray(inp_all[idx]),
            partial(ref_attn.attention_reference, causal=True), 0, p)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(tgt_all[idx]))
        mask = (jnp.asarray(tgt_all[idx]) != 0).astype(jnp.float32)
        return jnp.sum(ce * mask) / jnp.maximum(jnp.sum(mask), 1.0) + aux

    return jax.device_get(jax.grad(loss)(init))


def _flat(tree) -> dict:
    return {k: v.numpy() for k, v in
            sequence_params_from_numpy(tree, device="cpu").items()}


def _ref_params(case):
    mesh_shape, params = CASES[case]
    p = ref.SequenceParams(**params)
    if p.attention == "flash":
        # the reference's flash is its Pallas kernel (interpret mode on
        # the CPU) with chunked attention's gradients: the plain
        # attention is the same function
        p = dataclasses.replace(p, attention="reference")
    return p


def _write_case(arrays: dict, name: str, data, params: dict, mesh: tuple,
                init) -> dict:
    arrays[f"{name}/seqs"] = data.seqs
    for k, v in _flat(init).items():
        arrays[f"{name}/init/{k}"] = v
    return {"name": name, "mesh": list(mesh), "n_items": len(data.items),
            "params": params}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_sequence")
    data = _data()
    out = {}
    for world, names in WORLD.items():
        d = tmp / f"world{world}"
        d.mkdir()
        arrays, spec = {}, {"cases": []}
        for name in names:
            mesh, params = CASES[name]
            init = _ref_init(len(data.items), _ref_params(name))
            spec["cases"].append(_write_case(arrays, name, data, params,
                                             mesh, init))
        if world == 2:
            init = _ref_init(len(data.items), _ref_params("flash"))
            spec["refusals"] = [
                _write_case(arrays, "local", data,
                            dict(SMALL, attention="reference"), (1, 2, 1),
                            init),
                _write_case(arrays, "divisible", data,
                            dict(SMALL, num_heads=1, embed_dim=32,
                                 attention="ulysses"), (1, 2, 1), init),
                _write_case(arrays, "headroom", _data(max_len=34),
                            dict(SMALL, max_len=17), (1, 2, 1), init),
                _write_case(arrays, "needs_seq", data,
                            dict(SMALL, attention="ring"), (2, 1, 1),
                            init)]
            ck = _write_case(arrays, "ckpt", data,
                             dict(SMALL, steps=10, attention="flash"),
                             (2, 1, 1), init)
            spec["checkpoints"] = [dict(ck, dir=str(d / "ckpt"), every=3,
                                        stop=5)]
        np.savez(d / "in.npz", **arrays)
        (d / "in.json").write_text(json.dumps(spec))
        outs = run_ranks(
            lambda r: [os.path.join(TESTS, "_torch_mesh_worker.py"),
                       "sequence", str(d)], world)
        for rc, _, err in outs:
            assert rc == 0, err[-3000:]
        out[world] = [dict(np.load(d / f"rank{r}.npz"))
                      for r in range(world)]
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's sharded runs, from its own init, and its first
    step's gradients."""
    data = _data()
    out = {}
    for name, (shape, _) in CASES.items():
        p = _ref_params(name)
        world = int(np.prod(shape))
        mesh = ref_mesh(MeshConfig(*shape), jax.devices()[:world])
        init = _ref_init(len(data.items), p)
        params, _, loss = ref.train_sequence_model(data, p, mesh)
        out[name] = {"loss": loss, "params": _flat(params),
                     "grads": _flat(_ref_first_grads(data, p, mesh, init)),
                     "single": _flat(_single_grads(data, p, init)),
                     "world": world}
    return out


def _ranks(worlds, name):
    world = next(w for w, names in WORLD.items() if name in names)
    return worlds[world]


def _close(got: dict, want: dict, prefix: str, rtol=0.0, atol=0.0):
    keys = {k[len(prefix):] for k in got if k.startswith(prefix)}
    assert keys == set(want), keys ^ set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30) if rtol else 1.0
        np.testing.assert_allclose(got[prefix + k], w, rtol=0,
                                   atol=max(atol, rtol * scale), err_msg=k)


@pytest.mark.parametrize("name", ["ring", "ulysses", "flash", "moe"])
def test_first_step_gradients_carry_the_references_factor(worlds, reference,
                                                          name):
    """Every rank's summed gradient is the reference's, which is n_data *
    n_seq times the one-device gradient."""
    want = reference[name]
    factor = want["world"]
    single = want["single"]
    if name != "moe":
        for k, g in want["grads"].items():
            np.testing.assert_allclose(
                g, factor * single[k], rtol=0,
                atol=GRAD_RTOL * factor * max(float(np.abs(single[k]).max()),
                                              1e-30), err_msg=k)
    for r in _ranks(worlds, name):
        _close(r, want["grads"], f"{name}/grads/", rtol=GRAD_RTOL)


@pytest.mark.parametrize("name", ["ring", "ulysses", "flash"])
def test_sharded_training_equals_reference(worlds, reference, name):
    ranks = _ranks(worlds, name)
    want = reference[name]
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}/loss"], want["loss"],
                                   rtol=LOSS_RTOL)
        _close(r, want["params"], f"{name}/params/", atol=PARAM_ATOL)
        # every rank ends with the same params, bit for bit
        for k in want["params"]:
            np.testing.assert_array_equal(r[f"{name}/params/{k}"],
                                          ranks[0][f"{name}/params/{k}"])


def test_moe_sharded_training_is_the_references_ballpark(worlds, reference):
    for r in _ranks(worlds, "moe"):
        assert abs(float(r["moe/loss"]) - reference["moe"]["loss"]) \
            < MOE_LOSS_ATOL, (float(r["moe/loss"]), reference["moe"]["loss"])
        assert np.isfinite(r["moe/params/blocks.0.moe_w_in"]).all()


@pytest.mark.parametrize("case", ["local", "divisible", "headroom",
                                  "needs_seq"])
def test_refusals_are_the_references(worlds, case):
    """A local attention under seq > 1, ulysses with heads the seq axis
    does not divide, seq padding past the position table's headroom, and
    ring without a seq axis: the reference's ValueError, word for word."""
    # headroom: 33 inputs fill the 17 + 16 position rows, and the seq
    # axis of 2 pads them to 34
    data = _data(max_len=34 if case == "headroom" else 16)
    params = {"local": dict(SMALL, attention="reference"),
              "divisible": dict(SMALL, num_heads=1, attention="ulysses"),
              "headroom": dict(SMALL, max_len=17),
              "needs_seq": dict(SMALL, attention="ring")}[case]
    shape = (2, 1, 1) if case == "needs_seq" else (1, 2, 1)
    mesh = ref_mesh(MeshConfig(*shape), jax.devices()[:2])
    with pytest.raises(ValueError) as want:
        ref.train_sequence_model(data, ref.SequenceParams(**params), mesh)
    for r in worlds[2]:
        assert str(r[f"refuse/{case}"]) == str(want.value)
    assert {"local": "local-only", "divisible": "divisible",
            "headroom": "headroom", "needs_seq": "seq axis > 1"}[case] \
        in str(want.value)


def test_checkpoints_from_two_ranks_resume_to_the_uninterrupted_run(worlds):
    """data 2 x seq 1 with saves every 3 steps: rank 0 alone writes; a run
    stopped after 5 steps and resumed from its step-3 save ends with the
    uninterrupted run's params and loss, bit for bit, on both ranks."""
    r0, r1 = worlds[2]
    assert int(r0["ckpt/writes"]) > 0 and int(r1["ckpt/writes"]) == 0
    assert list(r0["ckpt/whole/files"]) == ["3", "6", "9"]
    for r in (r0, r1):
        keys = [k for k in r if k.startswith("ckpt/whole/params/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                r[k.replace("/whole/", "/resumed/")], r[k], err_msg=k)
        assert float(r["ckpt/resumed/loss"]) == float(r["ckpt/whole/loss"])


# -- the train verb on two processes ------------------------------------------

APP = "MeshSeqApp"
FACTORY = "pio_tpu_torch.models.sequence.SequenceEngine"
VERB_ALGO = dict(max_len=12, embed_dim=16, num_heads=2, num_layers=1,
                 ffn_dim=32, steps=25, batch_size=33, learning_rate=3e-3,
                 seed=5)
RUN_ID = "mesh-seq-run-0001"
_VERB = textwrap.dedent("""
    import logging, sys
    import _torch_cpu
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    from pio_tpu_torch.__main__ import main
    sys.exit(main(["train", "--engine-dir", sys.argv[1], "--device",
                   "cpu"]))
""")


def _sqlite_env(d) -> dict:
    return {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(d / "pio.db"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}


def _verb_store(d):
    from pio_tpu_torch.data.dao import App
    from pio_tpu_torch.data.event import Event
    from pio_tpu_torch.data.storage import Storage

    d.mkdir()
    storage = Storage(env=_sqlite_env(d))
    app_id = storage.get_metadata_apps().insert(App(0, APP))
    events = storage.get_events()
    events.init(app_id)
    rng = np.random.default_rng(9)
    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    events.insert_batch([Event(
        event="view", entity_type="user", entity_id=f"u{u}",
        target_entity_type="item",
        target_entity_id=f"i{int(rng.integers(0, 20))}",
        event_time=t0 + timedelta(seconds=100 * u + t))
        for u in range(40) for t in range(int(rng.integers(2, 12)))], app_id)
    engine = d / "engine"
    engine.mkdir()
    (engine / "engine.json").write_text(json.dumps({
        "id": "seq", "engineFactory": FACTORY,
        "datasource": {"params": {"app_name": APP, "max_len": 12}},
        "algorithms": [{"name": "sasrec", "params": VERB_ALGO}]}))
    return storage, engine


def _to_ref_tree(state: dict, template) -> dict:
    """The port's state dict -> the reference's params tree (the inverse
    of ``convert.sequence_params_from_numpy`` on ``template``'s
    structure)."""
    state = {k: np.asarray(v) for k, v in state.items()}
    tree = {"item_emb": state["item_emb"], "pos_emb": state["pos_emb"],
            "LayerNorm_0": {"scale": state["ln_f.weight"],
                            "bias": state["ln_f.bias"]}}
    i = 0
    while f"Block_{i}" in template:
        block = {}
        for flax_name, name in _BLOCK_DENSE:
            if flax_name in template[f"Block_{i}"]:
                node = {"kernel": state[f"blocks.{i}.{name}.weight"].T}
                if f"blocks.{i}.{name}.bias" in state:
                    node["bias"] = state[f"blocks.{i}.{name}.bias"]
                block[flax_name] = node
        for name in _BLOCK_MOE:
            if name in template[f"Block_{i}"]:
                block[name] = state[f"blocks.{i}.{name}"]
        for flax_name, name in _BLOCK_NORM:
            block[flax_name] = {"scale": state[f"blocks.{i}.{name}.weight"],
                                "bias": state[f"blocks.{i}.{name}.bias"]}
        tree[f"Block_{i}"] = block
        i += 1
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_train_verb_on_two_ranks_trains_the_references_mesh_batch(
        tmp_path, monkeypatch):
    """Two train-verb processes on one store with batch_size 33: the
    context's data=2 mesh makes the step's batch 32, split 16 a rank, as
    the reference's dp step does. From the port's seeded init (carried to
    the reference), the verb's final loss and the persisted params are
    the reference's on a data=2 mesh; a rank training alone on 33 rows
    would part from both."""
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.models.sequence import (
        SequenceDataSource,
        SequenceDataSourceParams,
    )
    from pio_tpu_torch.workflow.context import create_workflow_context
    from pio_tpu_torch.workflow.train import load_models

    storage, engine = _verb_store(tmp_path / "store")
    try:
        outs = run_ranks(lambda r: ["-c", _VERB, str(engine)], 2,
                         env_of=lambda r: _sqlite_env(tmp_path / "store")
                         | {"PIO_TPU_RUN_ID": RUN_ID})
        losses = []
        for r, (rc, out, err) in enumerate(outs):
            assert rc == 0, err[-3000:]
            assert f"Training on rank {r} of 2 (cpu, gloo)" in out
            losses.append(float(re.search(r"final loss ([-0-9.e]+)",
                                          err).group(1)))
        assert losses[0] == losses[1]
        eng = port.SequenceEngine.apply()
        ep = eng.engine_params_from_variant(
            json.loads((engine / "engine.json").read_text()))
        ctx = create_workflow_context(Storage(env=_sqlite_env(
            tmp_path / "store")), device="cpu")
        (model,) = load_models(ctx.storage, eng, ep, RUN_ID, ctx)
        data = SequenceDataSource(SequenceDataSourceParams(
            app_name=APP, max_len=12)).read_training(ctx)
    finally:
        storage.close()

    p = ref.SequenceParams(**VERB_ALGO)
    enc = port.init_encoder_(port.make_encoder(len(data.items),
                                               port.SequenceParams(
                                                   **VERB_ALGO)), p.seed)
    ref_data = ref.SequenceData(data.seqs, data.users, data.items)
    template = _ref_init(len(data.items), p)
    init = _to_ref_tree(enc.state_dict(), template)
    monkeypatch.setattr(ref.SeqEncoder, "init",
                        lambda self, *a, **kw: {"params": init})
    mesh = ref_mesh(MeshConfig(data=2), jax.devices()[:2])
    params, _, loss = ref.train_sequence_model(ref_data, p, mesh)
    np.testing.assert_allclose(losses[0], loss, rtol=LOSS_RTOL)
    want = _flat(params)
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(model.params[k]), w, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
