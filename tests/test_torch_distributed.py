"""The port's process group and mesh (``pio_tpu_torch.parallel``) against
``pio_tpu.parallel``: the same environment parsing and validation, the
same single-process behaviour and topology keys, and real groups of
processes on the CPU over gloo (a group of one through the variables, as
tests/test_distributed.py brings one up; two agreeing on
``any_process`` and passing a barrier; a rank whose coordinator never
answers)."""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import textwrap

import numpy as np
import pytest

from _torch_dist import run_ranks
from pio_tpu.parallel import distributed as ref_dist
from pio_tpu.parallel import mesh as ref_mesh
from pio_tpu_torch.parallel import distributed, mesh

ENV_KEYS = ("PIO_TPU_COORDINATOR", "PIO_TPU_NUM_PROCESSES",
            "PIO_TPU_PROCESS_ID")


@pytest.mark.parametrize("env", [
    {},
    {"PIO_TPU_COORDINATOR": ""},
    {"PIO_TPU_COORDINATOR": "10.0.0.1:8476", "PIO_TPU_NUM_PROCESSES": "4",
     "PIO_TPU_PROCESS_ID": "2"},
    {"PIO_TPU_COORDINATOR": "10.0.0.1:8476"},
    {"PIO_TPU_COORDINATOR": "10.0.0.1:8476", "PIO_TPU_NUM_PROCESSES": "2"},
    {"PIO_TPU_COORDINATOR": "10.0.0.1:8476", "PIO_TPU_PROCESS_ID": "0"},
    {"PIO_TPU_NUM_PROCESSES": "2", "PIO_TPU_PROCESS_ID": "1"},
], ids=["none", "empty", "full", "coordinator-only", "no-id", "no-count",
        "no-coordinator"])
def test_distributed_env_is_the_reference(monkeypatch, env):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed.distributed_env() == ref_dist.distributed_env()


def test_partial_config_raises_the_reference_error(monkeypatch):
    monkeypatch.setenv("PIO_TPU_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.delenv("PIO_TPU_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("PIO_TPU_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="num_processes") as got:
        distributed.initialize_distributed(device="cpu")
    with pytest.raises(ValueError) as want:
        ref_dist.initialize_distributed()
    assert str(got.value) == str(want.value)


def test_single_process_is_noop(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_distributed(device="cpu") is False
    assert distributed.is_primary()
    assert distributed.any_process(True) is True
    assert distributed.any_process(False) is False
    distributed.barrier("noop")
    info = distributed.runtime_info()
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] >= 1
    assert info["distributed"] is False
    m = mesh.create_mesh(device="cpu")
    assert (m.size, m.rank, str(m.device)) == (1, 0, "cpu")
    assert m.shape == {"data": 1, "seq": 1, "model": 1}
    x = np.arange(6.0)
    import torch

    t = torch.from_numpy(x)
    assert m.psum(t) is t and m.all_gather(t) is t


def test_runtime_info_has_the_reference_keys():
    assert set(distributed.runtime_info()) == set(ref_dist.runtime_info())


@pytest.mark.parametrize("cfg,n", [
    ({}, 1), ({}, 8), ({"data": 2}, 8), ({"data": 2, "model": 2}, 8),
    ({"data": -1, "seq": 2}, 8), ({"data": 4, "model": 4}, 8),
])
def test_mesh_config_resolves_as_the_reference(cfg, n):
    def resolve(cls):
        try:
            return cls(**cfg).resolve(n)
        except ValueError as e:
            return str(e)

    assert resolve(mesh.MeshConfig) == resolve(ref_mesh.MeshConfig)


def test_mesh_axes_beyond_data_are_refused():
    """The seq and model axes resolve now (their groups are exercised
    across ranks in tests/test_torch_mesh_collectives.py): over 8 ranks
    each shape's rank layout is the reference's device layout,
    reshape(data, seq, model), and a mesh that needs more ranks than the
    one process is the reference's ValueError."""
    import jax

    for cfg in ({"data": 2, "seq": 2, "model": 2}, {"seq": 2},
                {"data": 1, "seq": 2, "model": 4}, {"model": 4}):
        shape = dict(zip(mesh.AXES, mesh.MeshConfig(**cfg).resolve(8)))
        assert shape == dict(zip(mesh.AXES,
                                 ref_mesh.MeshConfig(**cfg).resolve(8)))
        grid = np.asarray(ref_mesh.create_mesh(
            ref_mesh.MeshConfig(**cfg), jax.devices()[:8]).devices)
        for r in range(8):
            coords = mesh.rank_coords(r, shape)
            assert grid[coords].id == r, (cfg, r, coords)
            m = mesh.Mesh(shape, r, None)
            assert [m.axis_index(a) for a in mesh.AXES] == list(coords)
        assert m.axis_size(("data", "seq")) == shape["data"] * shape["seq"]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh.create_mesh(mesh.MeshConfig(data=1, seq=2), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        mesh.create_mesh(mesh.MeshConfig(data=1, model=2), device="cpu")


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (0, 3)])
def test_pad_to_multiple_is_the_reference(n, multiple):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got, got_n = mesh.pad_to_multiple(x, multiple)
    want, want_n = ref_mesh.pad_to_multiple(x, multiple)
    np.testing.assert_array_equal(got, want)
    assert got_n == want_n


_ONE = textwrap.dedent("""
    import _torch_cpu
    from pio_tpu_torch.data.storage import Storage
    from pio_tpu_torch.parallel import distributed
    from pio_tpu_torch.workflow.context import create_workflow_context
    ctx = create_workflow_context(Storage(env={
        "PIO_STORAGE_SOURCES_M_TYPE": "memory",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M"}), device="cpu")
    info = distributed.runtime_info()
    assert info["distributed"] and info["process_count"] == 1, info
    assert distributed.backend() == "gloo"
    assert ctx.mesh is not None and ctx.mesh.size == 1
    assert str(ctx.device) == "cpu"
    assert distributed.any_process(True) and distributed.is_primary()
    assert distributed.initialize_distributed(device="cpu") is False
    print("DISTRIBUTED_OK")
""")


def test_real_coordinator_single_process():
    """A subprocess joins a real one-process group through the variables
    and builds a workflow context on it."""
    ((rc, out, err),) = run_ranks(lambda r: ["-c", _ONE], 1, timeout=120)
    assert rc == 0, err[-3000:]
    assert "DISTRIBUTED_OK" in out


_TWO = textwrap.dedent("""
    import sys
    import _torch_cpu
    import torch
    from pio_tpu_torch.parallel import create_mesh, distributed
    assert distributed.initialize_distributed(device="cpu") is True
    m = create_mesh(device="cpu")
    r = m.rank
    both = [distributed.any_process(r == 1), distributed.any_process(False),
            distributed.any_process(True)]
    distributed.barrier("test")
    total = m.psum(torch.full((2, 2), float(r + 1)))
    gathered = m.all_gather(torch.full((r + 2, 3), float(r))[:2])
    print("RANK", r, distributed.is_primary(), both, total.tolist(),
          gathered[:, 0].tolist(), distributed.runtime_info()[
              "process_count"], flush=True)
""")


def test_two_processes_agree_and_pass_a_barrier():
    outs = run_ranks(lambda r: ["-c", _TWO], 2, timeout=120)
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        line = next(ln for ln in out.splitlines() if ln.startswith("RANK"))
        assert line == (f"RANK {rank} {rank == 0} [True, False, True] "
                        "[[3.0, 3.0], [3.0, 3.0]] [0.0, 0.0, 1.0, 1.0] 2")


def test_unreachable_coordinator_fails_within_its_timeout():
    """Rank 1 of 2 whose coordinator (rank 0) never starts fails with a
    non-zero exit once the stated timeout passes: it never trains
    alone."""
    code = textwrap.dedent("""
        import _torch_cpu
        from pio_tpu_torch.parallel import distributed
        distributed.initialize_distributed(device="cpu")
        print("JOINED")
    """)
    outs = run_ranks(lambda r: ["-c", code], 1, timeout=120,
                     env_of=lambda r: {"PIO_TPU_NUM_PROCESSES": "2",
                                       "PIO_TPU_PROCESS_ID": "1",
                                       "PIO_TPU_COORDINATOR_TIMEOUT_S": "3"})
    ((rc, out, err),) = outs
    assert rc != 0 and "JOINED" not in out
    assert "could not join the group" in err and "within 3 s" in err
