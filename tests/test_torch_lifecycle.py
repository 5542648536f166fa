"""The port's supervised train workflow against the JAX package's.

First the lifecycle's pieces on the same instance rows in both packages'
sqlite stores: the zombie sweep, ``find_resumable``, the heartbeat
throttle and ``checkpoint_dir_for``. Then ``run_train``'s transitions
(COMPLETED, FAILED with the training error kept, INTERRUPTED on
preemption or a debug stop, FAILED on a ``train.persist`` fault) from the
same stub engines in both packages. Then the port's own runs of the
sequence template through ``python -m pio_tpu_torch train --device cpu``:
a ``train.step.<n>`` chaos kill, then ``--resume``, gives parameters
bit-identical to an uninterrupted run; a wrong engine triple on
``--resume`` raises; a SIGTERM'd subprocess exits with 75 and
``--auto-resume`` completes it. Every comparison here is exact.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import json
import os
import signal
import subprocess
import sys
import time
import types
from contextlib import nullcontext
from datetime import timedelta

import pytest
import torch

from pio_tpu.controller.base import TrainingInterruption as RefInterruption
from pio_tpu.controller.engine import EngineParams as RefEngineParams
from pio_tpu.data.dao import EngineInstance as RefInstance
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.resilience import chaos as ref_chaos
from pio_tpu.workflow import lifecycle as ref_lc
from pio_tpu.workflow import train as ref_train
from pio_tpu.workflow.context import (
    create_workflow_context as ref_context,
)
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.controller.base import TrainingInterruption
from pio_tpu_torch.controller.engine import EngineParams
from pio_tpu_torch.data.dao import App, EngineInstance
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.models import sequence as seq
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.utils.time import utcnow
from pio_tpu_torch.workflow import lifecycle as lc
from pio_tpu_torch.workflow import train as port_train
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.train import load_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP = "LcApp"
SEQ_FACTORY = "pio_tpu_torch.models.sequence.SequenceEngine"
TINY = {"max_len": 8, "embed_dim": 8, "num_heads": 2, "num_layers": 1,
        "ffn_dim": 16, "batch_size": 8, "steps": 30, "seed": 3,
        "checkpoint_every": 5}


def _env(path):
    return {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(path),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}


@pytest.fixture
def both(tmp_path):
    port = Storage(env=_env(tmp_path / "port.db"))
    ref = RefStorage(env=_env(tmp_path / "ref.db"))
    yield port, ref
    port.close()
    ref.close()


def _rows(now, ckpt_root):
    """(id, status, age, progress) rows: live and stale in-flight runs,
    terminal ones, resumable ones with and without steps on disk, and
    other engines'."""
    full = os.path.join(ckpt_root, "full")
    old = os.path.join(ckpt_root, "old")
    empty = os.path.join(ckpt_root, "empty")
    for d, steps in ((full, ["5", "10"]), (old, ["0"]), (empty, [])):
        os.makedirs(d, exist_ok=True)
        for s in steps:
            open(os.path.join(d, s), "wb").close()
    open(os.path.join(empty, ".10.tmp.99"), "wb").close()  # a torn write
    hb = lambda s: {"heartbeat": (now - timedelta(seconds=s)).isoformat()}
    return [
        ("init-stale", "INIT", 3600, {}),
        ("init-fresh", "INIT", 30, {}),
        ("train-stale-beat", "TRAINING", 7200, hb(900)),
        ("train-live-beat", "TRAINING", 7200, hb(20)),
        ("train-bad-beat", "TRAINING", 7200, {"heartbeat": "not a time"}),
        ("done", "COMPLETED", 7200, {}),
        ("int-newest-empty", "INTERRUPTED", 60, {"checkpoint_dir": empty}),
        ("failed-full", "FAILED", 120, {"checkpoint_dir": full}),
        ("int-old", "INTERRUPTED", 600, {"checkpoint_dir": old}),
        ("other-engine", "FAILED", 10, {"checkpoint_dir": full}),
    ]


def _insert(storage, cls, rows, now):
    instances = storage.get_metadata_engine_instances()
    for iid, status, age, progress in rows:
        t = now - timedelta(seconds=age)
        instances.insert(cls(
            id=iid, status=status, start_time=t, end_time=t,
            engine_id="other" if iid == "other-engine" else "lc",
            engine_version="1", engine_variant="default",
            engine_factory="", progress=dict(progress)))
    return instances


def test_sweep_and_find_resumable_equal_the_reference(both, tmp_path):
    port, ref = both
    now = utcnow()
    rows = _rows(now, str(tmp_path / "ck"))
    p_inst = _insert(port, EngineInstance, rows, now)
    r_inst = _insert(ref, RefInstance, rows, now)
    got = lc.sweep_zombies(port, now=now)
    want = ref_lc.sweep_zombies(ref, now=now)
    assert [i.id for i in got] == [i.id for i in want]
    assert {i.id for i in got} == {"init-stale", "train-stale-beat",
                                   "train-bad-beat"}
    for a, b in zip(sorted(p_inst.get_all(), key=lambda i: i.id),
                    sorted(r_inst.get_all(), key=lambda i: i.id)):
        assert (a.id, a.status, a.progress) == (b.id, b.status, b.progress)
    for root in (None, str(tmp_path / "elsewhere")):
        g = lc.find_resumable(p_inst, "lc", "1", "default", root)
        w = ref_lc.find_resumable(r_inst, "lc", "1", "default", root)
        assert g.id == w.id == "failed-full"
    # the newest resumable run with steps wins once it has one
    open(os.path.join(str(tmp_path / "ck"), "empty", "15"), "wb").close()
    assert lc.find_resumable(p_inst, "lc", "1", "default").id == \
        ref_lc.find_resumable(r_inst, "lc", "1", "default").id == \
        "int-newest-empty"


class _Recorder:
    def __init__(self):
        self.steps = []

    def update(self, inst):
        self.steps.append(inst.progress["step"])


@pytest.mark.parametrize("every, min_s", [(10, 0.0), (1, 2.0), (5, 1.0)])
def test_heartbeat_throttle_equals_the_reference(monkeypatch, every, min_s):
    calls = [(0, 0.0, True)] + [(s, 0.4, False) for s in range(1, 40)] + [
        (128, 5.0, False), (129, 5.0, False), (200, 0.0, True)]
    out = []
    for mod, cls in ((lc, EngineInstance), (ref_lc, RefInstance)):
        clock = [100.0]
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda: clock[0]))
        rec = _Recorder()
        t = utcnow()
        life = mod.TrainLifecycle(
            rec, cls(id="x", status="TRAINING", start_time=t, end_time=t,
                     engine_id="e", engine_version="1",
                     engine_variant="default", engine_factory=""),
            checkpoint_dir="/ck/x", heartbeat_every_steps=every,
            heartbeat_min_interval_s=min_s)
        wrote = []
        for step, advance, force in calls:
            clock[0] += advance
            wrote.append(life.heartbeat(step, 300, force=force))
        out.append((wrote, rec.steps, life.last_step,
                    {k: v for k, v in life.instance.progress.items()
                     if k not in ("heartbeat", "pid", "host")}))
    assert out[0] == out[1]
    assert 2 < sum(out[0][0]) < len(calls)


@pytest.mark.parametrize("env, root", [
    ({}, None),
    ({"PIO_TPU_HOME": "/srv/pio"}, None),
    ({"PIO_TPU_HOME": "/srv/pio", "PIO_TPU_CKPT_ROOT": "/ck"}, None),
    ({"PIO_TPU_CKPT_ROOT": "/ck"}, "/given"),
])
def test_checkpoint_dir_for_equals_the_reference(monkeypatch, env, root):
    for k in ("PIO_TPU_HOME", "PIO_TPU_CKPT_ROOT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for iid in ("abc", "a/b/c"):
        assert lc.checkpoint_dir_for(iid, root) == \
            ref_lc.checkpoint_dir_for(iid, root)


# -- run_train's transitions, the same stub engines in both packages ---------

def _stub(pkg, outcome, break_store):
    """An engine whose train does ``outcome``: "ok" returns one model,
    "boom" raises ValueError, "preempt" raises TrainingPreempted(7),
    "stop" raises TrainingInterruption (a --stop-after-read), and
    "store-down" breaks the store's status writes (``break_store``),
    then raises."""
    preempted = (lc if pkg == "port" else ref_lc).TrainingPreempted
    interruption = TrainingInterruption if pkg == "port" else RefInterruption

    class Stub:
        def train(self, ctx, ep, stop_after_read=False,
                  stop_after_prepare=False):
            if outcome == "ok":
                return [{"weights": [1.0, 2.0]}]
            if outcome == "preempt":
                raise preempted(7)
            if outcome == "stop":
                raise interruption("stop after read")
            if outcome == "store-down":
                break_store()
            raise ValueError("the real training bug")

    return Stub


def _store_down(*_):
    raise ConnectionError("metadata store down")


def _run(pkg, storage, outcome, ckpt_root, break_store,
         persist_fault=False):
    engine = _stub(pkg, outcome, break_store)()
    if pkg == "port":
        ctx = create_workflow_context(storage, device="cpu")
        run, ep, inject = port_train.run_train, EngineParams(), chaos.inject
    else:
        ctx = ref_context(storage, use_mesh=False)
        run, ep, inject = ref_train.run_train, RefEngineParams(), \
            ref_chaos.inject
    with (inject("train.persist", error=1.0) if persist_fault
          else nullcontext()):
        return run(engine, ep, storage, engine_id="lc", ctx=ctx,
                   checkpoint_root=ckpt_root)


_VOLATILE = ("heartbeat", "pid", "host", "checkpoint_dir", "resumed_at")


@pytest.mark.parametrize("outcome, persist_fault, status", [
    ("ok", False, "COMPLETED"),
    ("ok", True, "FAILED"),
    ("boom", False, "FAILED"),
    ("preempt", False, "INTERRUPTED"),
    ("stop", False, "INTERRUPTED"),
    ("store-down", False, "TRAINING"),
])
def test_run_train_transitions_equal_the_reference(tmp_path, monkeypatch,
                                                   outcome, persist_fault,
                                                   status):
    results = {}
    for pkg in ("port", "ref"):
        env = _env(tmp_path / f"{pkg}.db")
        # both stores without their retrying DAO proxy, so a broken
        # store fails at once and the DAO class can be patched
        storage = (Storage if pkg == "port" else RefStorage)(
            env=env, resilience=False)
        dao_cls = type(storage.get_metadata_engine_instances())
        original = dao_cls.update

        def break_store():
            monkeypatch.setattr(dao_cls, "update", _store_down)
        try:
            try:
                iid = _run(pkg, storage, outcome, str(tmp_path / pkg),
                           break_store, persist_fault)
                error = None
            except Exception as e:  # noqa: BLE001 - compared below
                error, iid = e, None
            monkeypatch.setattr(dao_cls, "update", original)
            [inst] = storage.get_metadata_engine_instances().get_all()
            blob = storage.get_model_data_models().get(inst.id)
        finally:
            storage.close()
        results[pkg] = (
            iid == inst.id if iid else None, type(error).__name__,
            str(error), type(error.__cause__).__name__ if error else None,
            inst.status, blob is not None,
            {k: v for k, v in inst.progress.items() if k not in _VOLATILE})
    assert results["port"] == results["ref"]
    assert results["port"][4] == status


# -- the port's own runs of the sequence template on the CPU -----------------

def _write_events(storage, n_users=24, steps=10):
    app_id = storage.get_metadata_apps().insert(App(0, APP))
    events = storage.get_events()
    events.init(app_id)
    t0 = utcnow() - timedelta(days=1)
    events.insert_batch([
        Event("view", "user", f"u{u}", "item", f"i{(u % 5 + t) % 16}", {},
              t0 + timedelta(seconds=u * steps + t))
        for u in range(n_users) for t in range(steps)], app_id)


def _engine_dir(tmp_path, name="eng", engine_id="seq-lc", **algo):
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    (d / "engine.json").write_text(json.dumps({
        "id": engine_id, "engineFactory": SEQ_FACTORY,
        "datasource": {"params": {"app_name": APP, "max_len": 8}},
        "algorithms": [{"name": "sasrec", "params": {**TINY, **algo}}]}))
    return d


@pytest.fixture
def seq_store(tmp_path, monkeypatch):
    env = _env(tmp_path / "seq.db")
    storage = Storage(env=env)
    _write_events(storage)
    monkeypatch.setattr("pio_tpu_torch.__main__.get_storage",
                        lambda: storage)
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    yield storage, env
    storage.close()


def _train(engine_dir, *extra):
    return port_main(["train", "--engine-dir", str(engine_dir), "--device",
                      "cpu", *extra])


def _params(storage, engine_dir, iid):
    engine = seq.SequenceEngine.apply()
    variant = json.loads((engine_dir / "engine.json").read_text())
    ep = engine.engine_params_from_variant(variant)
    [model] = load_models(storage, engine, ep, iid,
                          create_workflow_context(storage, device="cpu"))
    return model.params


def _assert_same_params(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _completed(storage):
    return [i for i in storage.get_metadata_engine_instances().get_all()
            if i.status == "COMPLETED"]


@pytest.fixture
def uninterrupted(seq_store, tmp_path):
    storage, _ = seq_store
    d = _engine_dir(tmp_path)
    assert _train(d) == 0
    [done] = _completed(storage)
    assert done.progress["step"] == TINY["steps"] - 1
    assert sorted(os.listdir(done.progress["checkpoint_dir"]),
                  key=int) == ["15", "20", "25"]      # max_to_keep 3
    return d, _params(storage, d, done.id), done.id


@pytest.mark.parametrize("kill_at", [7, 10])
def test_step_chaos_then_resume_is_bit_identical(seq_store, uninterrupted,
                                                 kill_at):
    storage, _ = seq_store
    d, want, done_id = uninterrupted
    with chaos.inject(f"train.step.{kill_at}", error=1.0):
        with pytest.raises(chaos.ChaosError):
            _train(d)
    [failed] = [i for i in storage.get_metadata_engine_instances().get_all()
                if i.status == "FAILED"]
    # the chaos point fires before step kill_at's cadence save
    steps = sorted(int(s) for s in os.listdir(
        failed.progress["checkpoint_dir"]))
    assert steps[-1] == (kill_at - 1) // 5 * 5
    assert storage.get_model_data_models().get(failed.id) is None
    assert _train(d, "--resume", failed.id) == 0
    inst = storage.get_metadata_engine_instances().get(failed.id)
    assert inst.status == "COMPLETED" and "resumed_at" in inst.progress
    _assert_same_params(_params(storage, d, failed.id), want)


def test_persist_chaos_fails_resumable_then_resumes(seq_store, tmp_path):
    storage, _ = seq_store
    d = _engine_dir(tmp_path, steps=12)
    with chaos.inject("train.persist", error=1.0):
        with pytest.raises(chaos.ChaosError):
            _train(d)
    [inst] = storage.get_metadata_engine_instances().get_all()
    assert inst.status == "FAILED"
    instances = storage.get_metadata_engine_instances()
    assert lc.find_resumable(instances, "seq-lc", "1", "default").id == \
        inst.id
    assert _train(d, "--auto-resume") == 0
    assert instances.get(inst.id).status == "COMPLETED"
    assert len(instances.get_all()) == 1


def test_checkpoint_write_fault_surfaces_then_resume_restores_the_last(
        seq_store, tmp_path):
    """A `train.checkpoint` fault fails the run (FAILED, resumable), no
    tmp file is left to look like a step, and a resume restores the last
    step that was written."""
    storage, _ = seq_store
    d = _engine_dir(tmp_path, steps=12)
    saves = []

    class Second(chaos.ChaosMonkey):
        def maybe(self, point):
            if point == "train.checkpoint":
                saves.append(point)
                if len(saves) == 3:          # the save of step 10
                    raise chaos.ChaosError("disk full", point)

    chaos.install(Second([]))
    try:
        with pytest.raises(chaos.ChaosError):
            _train(d)
    finally:
        chaos.uninstall()
    [inst] = storage.get_metadata_engine_instances().get_all()
    assert inst.status == "FAILED"
    assert sorted(os.listdir(inst.progress["checkpoint_dir"])) == ["0", "5"]
    assert _train(d, "--resume", inst.id) == 0


def test_resume_checks_the_instance_and_its_engine(seq_store, tmp_path):
    storage, _ = seq_store
    d = _engine_dir(tmp_path, steps=6)
    with chaos.inject("train.step.3", error=1.0):
        with pytest.raises(chaos.ChaosError):
            _train(d)
    [failed] = storage.get_metadata_engine_instances().get_all()
    other = _engine_dir(tmp_path, "other", engine_id="another-engine",
                        steps=6)
    with pytest.raises(ValueError, match="belongs to engine"):
        _train(other, "--resume", failed.id)
    with pytest.raises(ValueError, match="not found"):
        _train(d, "--resume", "ghost")
    assert _train(d, "--resume", failed.id, "--auto-resume") == 1
    assert _train(d, "--resume", failed.id) == 0
    with pytest.raises(ValueError, match="COMPLETED"):
        _train(d, "--resume", failed.id)


def test_stop_after_read_and_prepare_interrupt(seq_store, tmp_path, capsys):
    storage, _ = seq_store
    d = _engine_dir(tmp_path)
    assert _train(d, "--stop-after-read") == 0
    assert _train(d, "--stop-after-prepare") == 0
    assert "Training interrupted" in capsys.readouterr().out
    statuses = [i.status for i in
                storage.get_metadata_engine_instances().get_all()]
    assert statuses == ["INTERRUPTED", "INTERRUPTED"]


def test_sigterm_exits_75_then_auto_resume_completes(seq_store, tmp_path,
                                                     uninterrupted):
    """A SIGTERM'd train subprocess stops at the next step with a
    checkpoint and exit code 75; --auto-resume completes the same
    instance with the uninterrupted run's parameters. A chaos stall at
    step 12 holds the run while the signal arrives."""
    storage, env = seq_store
    d, want, done_id = uninterrupted
    ckpt_root = tmp_path / "ckpt"
    proc = subprocess.Popen(
        [sys.executable, "-m", "pio_tpu_torch", "train", "--engine-dir",
         str(d), "--device", "cpu"],
        cwd=REPO, env={**os.environ, **env,
                       "PIO_TPU_CKPT_ROOT": str(ckpt_root),
                       "PIO_TPU_CHAOS": "train.step.12:slow=1,slow_s=3"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            dirs = [ckpt_root / n for n in os.listdir(ckpt_root)
                    if n != done_id] if ckpt_root.exists() else []
            if any((p / "10").exists() for p in dirs):
                break
            time.sleep(0.02)
        assert proc.poll() is None, proc.communicate()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == lc.EXIT_PREEMPTED, out + err
    assert "resume with" in out
    [inst] = [i for i in storage.get_metadata_engine_instances().get_all()
              if i.id != done_id]
    assert inst.status == "INTERRUPTED" and inst.progress["resumable"]
    stopped = inst.progress["preempted_at_step"]
    assert stopped in (10, 11, 12)
    assert str(stopped) in os.listdir(inst.progress["checkpoint_dir"])
    assert _train(d, "--auto-resume") == 0
    assert storage.get_metadata_engine_instances().get(inst.id).status == \
        "COMPLETED"
    _assert_same_params(_params(storage, d, inst.id), want)


def test_preempted_trainer_force_saves_off_cadence(tmp_path):
    """A stop requested mid-run is honoured after the current step, with
    a checkpoint of that step although it is off the cadence."""
    from pio_tpu_torch.workflow.step_checkpoint import (
        StepCheckpointConfig,
        StepCheckpointer,
    )

    storage = Storage(env=_env(tmp_path / "p.db"))
    try:
        instances = storage.get_metadata_engine_instances()
        t = utcnow()
        iid = instances.insert(EngineInstance(
            id="", status="TRAINING", start_time=t, end_time=t,
            engine_id="e", engine_version="1", engine_variant="default",
            engine_factory=""))
        handler = lc.PreemptionHandler()
        life = lc.TrainLifecycle(instances, instances.get(iid),
                                 checkpoint_dir=str(tmp_path / "pc"),
                                 preemption=handler)
        seqs, users, items = seq.build_sequences(
            [types.SimpleNamespace(entity_id=f"u{u}",
                                   target_entity_id=f"i{(u + t) % 9}",
                                   event_time=t)
             for u in range(12) for t in range(6)], 6)
        p = seq.SequenceParams(**{**TINY, "max_len": 6, "steps": 20})
        ck = StepCheckpointer(StepCheckpointConfig(str(tmp_path / "pc"),
                                                   save_every=5))
        with chaos.inject("train.step.7", slow=1.0, slow_s=0.01,
                          sleep=lambda _: handler.requested.set()):
            with pytest.raises(lc.TrainingPreempted) as stopped:
                seq.train_sequence_model(
                    seq.SequenceData(seqs, users, items), p, device="cpu",
                    checkpoint=ck, lifecycle=life)
        assert stopped.value.step == 7
        assert sorted(os.listdir(tmp_path / "pc"), key=int) == ["0", "5",
                                                                 "7"]
        assert life.instance.progress["step"] == 7
        assert instances.get(iid).progress["step"] == 7
    finally:
        storage.close()
