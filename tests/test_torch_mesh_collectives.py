"""The port's mesh axes and sequence- and expert-parallel ops across gloo
ranks on the CPU, against the JAX package on the 8 CPU devices that
tests/conftest.py gives it.

Each group of ranks (2, then 4; ``tests/_torch_mesh_worker.py
collectives``, one process a rank) lays out meshes and sums its rank over
every line; runs ``ring_attention`` / ``ring_attention_sharded`` and
``ulysses_attention`` on its slice of the sequence, forward and the
gradients of sum(o**2), causal and not (the reference's
tests/test_attention.py:90-125); and ``moe_ffn_ep`` over the data axis
with a capacity that drops no token (tests/test_moe.py:86-106), and its
refusals.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _torch_dist import TESTS, run_ranks
from pio_tpu.ops import attention as ref_attn
from pio_tpu.ops import moe as ref_moe
from pio_tpu.parallel.mesh import MeshConfig, create_mesh as ref_mesh
from pio_tpu_torch.parallel import mesh as port_mesh

# attention outputs (f32, sums in other orders): the reference's own ring
# vs plain tolerance (tests/test_attention.py:94)
ATTN_ATOL = 2e-5
# gradients of sum(o**2): the reference's ring-gradient tolerance (:110)
GRAD_ATOL = 2e-4
# moe_ffn_ep against the reference's (tests/test_moe.py:94)
MOE_ATOL = 1e-5
B, S, H, D = 2, 16, 4, 8
MOE = dict(n_experts=4, d_model=16, d_ff=32, capacity_factor=32.0)
LAYOUTS = {2: [(2, 1, 1), (1, 2, 1), (1, 1, 2)],
           4: [(2, 2, 1), (2, 1, 2), (1, 2, 2), (4, 1, 1)]}


def _inputs():
    rng = np.random.default_rng(3)
    arrays = {x: rng.normal(size=(B, S, H, D)).astype(np.float32)
              for x in "qkv"}
    params = ref_moe.init_moe_params(jax.random.PRNGKey(7),
                                     ref_moe.MoEConfig(**MOE))
    arrays |= {f"moe/{k}": np.asarray(v, np.float32)
               for k, v in params.items()}
    arrays["moe/x"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(4), (32, MOE["d_model"])), np.float32)
    return arrays


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _run(tmp, world: int, arrays: dict) -> list:
    d = tmp / f"world{world}"
    d.mkdir()
    np.savez(d / "in.npz", **arrays)
    (d / "in.json").write_text(json.dumps({"layouts": LAYOUTS[world],
                                           "moe": MOE}))
    outs = run_ranks(lambda r: [os.path.join(TESTS, "_torch_mesh_worker.py"),
                                "collectives", str(d)], world)
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("collectives")
    return {w: _run(tmp, w, inputs) for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_layout_is_the_references_device_layout(worlds, world):
    """Rank r sits where the reference's reshape(data, seq, model) puts
    device r, and a psum / all_gather of the rank over each line sums /
    lists the ranks the reference's mesh puts on that line."""
    for shape in LAYOUTS[world]:
        name = "x".join(map(str, shape))
        grid = np.asarray(ref_mesh(MeshConfig(*shape),
                                   jax.devices()[:world]).devices)
        ids = np.vectorize(lambda dev: dev.id)(grid)
        for r, got in enumerate(worlds[world]):
            coords = tuple(got[f"layout/{name}/coords"])
            assert ids[coords] == r, (shape, r, coords)
            for axes, sl in ((("data",), np.s_[:, coords[1], coords[2]]),
                             (("seq",), np.s_[coords[0], :, coords[2]]),
                             (("model",), np.s_[coords[0], coords[1], :]),
                             (("data", "seq"), np.s_[:, :, coords[2]]),
                             (("seq", "model"), np.s_[coords[0], :, :]),
                             (None, np.s_[:, :, :])):
                key = "+".join(axes) if axes else "all"
                line = ids[sl].reshape(-1)
                assert got[f"layout/{name}/psum/{key}"][0] == line.sum()
                np.testing.assert_array_equal(
                    got[f"layout/{name}/gather/{key}"], line)


def test_mesh_with_more_ranks_than_one_process_refuses():
    """At one process a seq or model axis of 2 on a data axis of 1 is the
    reference's ValueError. With the data axis left to resolve (-1) the
    reference lays out an empty mesh (data 0); the port refuses that
    too."""
    for cfg in ({"data": 1, "seq": 2}, {"data": 1, "model": 2}):
        with pytest.raises(ValueError, match="needs 2 devices") as got:
            port_mesh.create_mesh(port_mesh.MeshConfig(**cfg), device="cpu")
        with pytest.raises(ValueError) as want:
            ref_mesh(MeshConfig(**cfg), jax.devices()[:1])
        assert str(got.value) == str(want.value)
    for cfg in ({"seq": 2}, {"model": 2}):
        with pytest.raises(ValueError, match="0x"):
            port_mesh.create_mesh(port_mesh.MeshConfig(**cfg), device="cpu")


def _ref_sharded(fn, world: int, causal: bool, q, k, v):
    mesh = ref_mesh(MeshConfig(data=1, seq=world), jax.devices()[:world])
    spec = P(None, "seq", None, None)
    return jax.shard_map(partial(fn, axis_name="seq", causal=causal),
                         mesh=mesh, in_specs=(spec, spec, spec),
                         out_specs=spec, check_vma=False)


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("op", ["ring", "ulysses"])
@pytest.mark.parametrize("world", [2, 4])
def test_sequence_parallel_attention_equals_reference(worlds, inputs, world,
                                                      op, causal):
    ranks = worlds[world]
    q, k, v = (jnp.asarray(inputs[x]) for x in "qkv")
    fn = {"ring": ref_attn.ring_attention,
          "ulysses": ref_attn.ulysses_attention}[op]
    run = _ref_sharded(fn, world, causal, q, k, v)
    want = np.asarray(run(q, k, v))
    np.testing.assert_allclose(_cat(ranks, f"{op}/{causal}/out"), want,
                               atol=ATTN_ATOL)
    np.testing.assert_allclose(
        want, ref_attn.attention_reference(q, k, v, causal=causal),
        atol=ATTN_ATOL)
    grads = jax.grad(lambda a, b, c: jnp.sum(run(a, b, c) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    for x, g in zip("qkv", grads):
        np.testing.assert_allclose(_cat(ranks, f"{op}/{causal}/d{x}"),
                                   np.asarray(g), atol=GRAD_ATOL)
    if op == "ring":
        sharded = ref_attn.ring_attention_sharded(
            q, k, v, ref_mesh(MeshConfig(data=1, seq=world),
                              jax.devices()[:world]), "seq", causal=causal)
        np.testing.assert_allclose(_cat(ranks, f"ring_sharded/{causal}"),
                                   np.asarray(sharded), atol=ATTN_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_moe_ffn_ep_equals_reference(worlds, inputs, world):
    cfg = ref_moe.MoEConfig(**MOE)
    params = {k: jnp.asarray(inputs[f"moe/{k}"])
              for k in ("router", "w_in", "b_in", "w_out", "b_out")}
    mesh = ref_mesh(MeshConfig(data=world), jax.devices()[:world])
    y, aux = ref_moe.moe_ffn_ep(params, jnp.asarray(inputs["moe/x"]), cfg,
                                mesh, axis="data")
    y1, _ = ref_moe.moe_ffn(params, jnp.asarray(inputs["moe/x"]), cfg)
    for r in worlds[world]:
        np.testing.assert_allclose(r["moe/y"], np.asarray(y), atol=MOE_ATOL)
        np.testing.assert_allclose(r["moe/y"], np.asarray(y1),
                                   atol=MOE_ATOL)
        np.testing.assert_allclose(r["moe/aux"], np.asarray(aux),
                                   atol=MOE_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_moe_ffn_ep_refuses_what_does_not_divide(worlds, world):
    for r in worlds[world]:
        assert "divide" in str(r["moe/refuse_experts"])
        assert "divide" in str(r["moe/refuse_tokens"])
