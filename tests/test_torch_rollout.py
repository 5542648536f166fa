"""The port's guarded rollout (``pio_tpu_torch/rollout/`` and the deploy's
two arms) as the JAX package's tests hold the reference's, on the CPU:

  * the split: deterministic, sticky, monotone, and ``canary_bucket``
    equal to the reference's for 10,000 seeded ids (non-ASCII among
    them), through the CRC32C wheel and through the port's byte loop;
  * single host: a canary serves each user its arm's solo answer bit for
    bit; a chaos'd guard breach rolls 100% back with no 5xx and a durable
    ROLLED_BACK verdict that /reload and a restart respect; promote
    reaches 100% and survives a restart; conflicts; the auto ramp; a
    candidate that only errors rolls back without the ticker;
  * fold-in on both arms, and a rollback racing an in-flight fold-in
    leaving the active arm bit-identical;
  * POST /reload with the GET alias, an abandoned IN_FLIGHT record, the
    ``deploy --canary``, ``promote`` and ``rollback`` verbs as processes;
  * a rolled-back or in-flight instance is never auto-loaded by the
    deploy or the fold-in worker, before or after /reload;
  * both arms through the continuous and the micro batcher: each arm's
    bodies are the port's solo answers for its instance bit for bit, the
    ids are the JAX ``QueryServer``'s on the same seeded instances and
    the scores within ``RTOL``/``ATOL`` of its (ROADMAP C3), and every
    query counts once in its arm's stats;
  * the fleet: ``deploy --canary`` and ``promote`` against the router,
    each user's body its arm's single-host answer bit for bit, and a
    corrupt candidate partition rolling back by itself.

Models are the reference tests' (20 users x 12 items, rank 4, trained by
the port on the CPU) or seeded factors persisted in both packages.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime, timedelta, timezone

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_fleet import time_limit  # noqa: F401

from pio_tpu.data.bimap import EntityIdIndex as RefIdIndex
from pio_tpu.data.dao import EngineInstance as RefEngineInstance
from pio_tpu.data.dao import Model as RefModel
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu.models import recommendation as ref_rec
from pio_tpu.ops import als as ref_als
from pio_tpu.rollout import canary_bucket as ref_canary_bucket
from pio_tpu.workflow.checkpoint import models_to_bytes as ref_models_to_bytes
from pio_tpu.workflow.context import create_workflow_context as ref_ctx
from pio_tpu.workflow.serve import QueryServer as RefQueryServer
from pio_tpu.workflow.serve import ServingConfig as RefServingConfig
from pio_tpu_torch.__main__ import main as port_main
from pio_tpu_torch.convert import recommendation_model_from_numpy
from pio_tpu_torch.data.dao import App, Model
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.freshness import FoldInConfig, FoldInWorker
from pio_tpu_torch.models import recommendation as port_rec
from pio_tpu_torch.ops import als
from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.rollout import (
    ARM_ACTIVE,
    ARM_CANDIDATE,
    VERDICT_IN_FLIGHT,
    VERDICT_PROMOTED,
    VERDICT_ROLLED_BACK,
    GuardConfig,
    RolloutConfig,
    RolloutController,
    RolloutRecord,
    canary_bucket,
    in_canary,
    load_record,
    save_record,
)
from pio_tpu_torch.server.plugins import (
    EngineServerPlugin,
    PluginContext,
    PluginRejection,
)
from pio_tpu_torch.serving_fleet.fleet import (
    deploy_fleet,
    resolve_fleet_model,
)
from pio_tpu_torch.serving_fleet.plan import (
    persist_fleet_artifacts,
    shard_model_id,
)
from pio_tpu_torch.utils import durable
from pio_tpu_torch.workflow.context import create_workflow_context
from pio_tpu_torch.workflow.serve import (
    QueryServer,
    ServingConfig,
    create_query_server,
)
from pio_tpu_torch.workflow.train import persist_models, run_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACTORY = "pio_tpu_torch.models.recommendation.RecommendationEngine"
T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
N_USERS = 20
KEY = "SRVKEY"
# the JAX package's scores on the same factors: the same f32 dots summed
# in another order
RTOL = 1e-5
ATOL = 1e-5


def _env(path) -> dict:
    return {
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": str(path / "pio.db"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL",
    }


def _variant(n_iter: int = 3) -> dict:
    return {"id": "rec", "engineFactory": FACTORY,
            "datasource": {"params": {"app_name": "mlapp"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "num_iterations": n_iter, "lambda_": 0.05,
                "chunk": 1024}}]}


def seed_events(storage) -> int:
    """The reference tests' events: 20 users x 12 items, two tastes."""
    app_id = storage.get_metadata_apps().insert(App(0, "mlapp"))
    ev = storage.get_events()
    ev.init(app_id)
    rng = np.random.default_rng(0)
    m = 0
    for u in range(N_USERS):
        for i in range(12):
            match = (u % 2) == (i % 2)
            if rng.random() < (0.8 if match else 0.1):
                ev.insert(Event(
                    event="rate", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{i}",
                    properties=DataMap({"rating": 5 if match else 1}),
                    event_time=T0 + timedelta(minutes=m)), app_id)
                m += 1
    return app_id


def train_instance(storage, ctx, n_iter: int):
    """One COMPLETED instance; another n_iter gives other factors, so the
    two arms' answers differ bit for bit."""
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(_variant(n_iter))
    iid = run_train(engine, ep, storage, engine_id="rec",
                    engine_factory=FACTORY, ctx=ctx)
    return engine, ep, iid


@pytest.fixture()
def two_instances(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_CKPT_ROOT", str(tmp_path / "ckpt"))
    storage = Storage(env=_env(tmp_path))
    seed_events(storage)
    ctx = create_workflow_context(storage, device="cpu")
    engine, ep, iid_a = train_instance(storage, ctx, 3)
    _, _, iid_b = train_instance(storage, ctx, 6)
    yield storage, engine, ep, ctx, iid_a, iid_b
    storage.close()


def oracle(storage, engine, ep, ctx, instance_id):
    """A pinned in-process QueryServer: what one arm should answer."""
    return QueryServer(engine, ep, storage,
                       ServingConfig(ip="127.0.0.1", port=0,
                                     engine_id="rec"),
                       ctx=ctx, instance_id=instance_id)


def serve_pinned(storage, engine, ep, ctx, instance_id, plugin_context=None,
                 **cfg):
    http, qs = create_query_server(
        engine, ep, storage,
        ServingConfig(ip="127.0.0.1", port=0, engine_id="rec", **cfg),
        ctx=ctx, instance_id=instance_id, plugin_context=plugin_context)
    http.start()
    return http, qs


def call(port, method, path, body=None, **params):
    qs = urllib.parse.urlencode(params)
    url = f"http://127.0.0.1:{port}{path}" + (f"?{qs}" if qs else "")
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


# -- split -------------------------------------------------------------------

def test_split_deterministic_sticky_monotone():
    assert canary_bucket("u7") == canary_bucket("u7")
    assert 0 <= canary_bucket("anyone") < 100
    for u in range(200):
        uid = f"u{u}"
        # monotone in pct: ramping up only ADDS users to the canary
        joined = False
        for pct in (0, 1, 5, 25, 50, 100):
            now = in_canary(uid, pct)
            assert now or not joined
            joined = joined or now
        assert in_canary(uid, 100) and not in_canary(uid, 0)


def _seeded_ids(n: int) -> list:
    """Short user ids as clients send them: ASCII, digits, and strings
    with accents, CJK, emoji and a NUL among them."""
    rng = np.random.default_rng(17)
    alphabet = list("abcdefghijklmnopqrstuvwxyz0123456789_-.@") + [
        "é", "ß", "ø", "ж", "λ", "中", "文", "ユ", "😀", "\x00"]
    out = [f"u{i}" for i in range(n // 2)]
    while len(out) < n:
        k = int(rng.integers(1, 24))
        out.append("".join(alphabet[j] for j in
                           rng.integers(0, len(alphabet), k)))
    out[-1] = 12345          # a non-string id goes through str()
    return out


@pytest.mark.parametrize("crc", ["wheel", "table"])
def test_canary_bucket_equals_the_reference(crc, monkeypatch):
    """10,000 seeded ids land in the reference's bucket, whichever CRC32C
    the port runs: the card's machine lacks ``google_crc32c``, so there
    the port hashes user ids with its table's byte loop."""
    if crc == "table":
        monkeypatch.setattr(durable, "_gcrc32c", None)
    ids = _seeded_ids(10_000)
    assert any(not str(u).isascii() for u in ids)
    got = [canary_bucket(u) for u in ids]
    assert got == [ref_canary_bucket(u) for u in ids]
    assert len(set(got)) == 100


# -- single host, end to end -------------------------------------------------

def test_canary_split_guard_breach_and_rollback_e2e(two_instances):
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a)
    qs_a = oracle(storage, engine, ep, ctx, iid_a)
    qs_b = oracle(storage, engine, ep, ctx, iid_b)
    try:
        pct = 40
        code, out = call(http.port, "POST", "/rollout/deploy",
                         {"pct": pct, "shadowEvery": 1, "checkEvery": 1,
                          "guards": {"maxDivergence": 1.0}})
        assert code == 200, out
        assert out["rollout"]["candidateInstanceId"] == iid_b
        assert out["rollout"]["baselineInstanceId"] == iid_a
        # sticky deterministic split: canary users get the candidate
        # oracle's answer bit for bit, the rest the active oracle's
        differ = 0
        for rep in range(2):
            for u in range(N_USERS):
                uid = f"u{u}"
                code, got = call(http.port, "POST", "/queries.json",
                                 {"user": uid, "num": 5})
                assert code == 200
                q = {"user": uid, "num": 5}
                want = (qs_b if in_canary(uid, pct) else qs_a).query(q)
                assert got == want, f"user {uid} rep {rep}"
                differ += qs_a.query(q) != qs_b.query(q)
        assert differ == 2 * N_USERS     # the arms' answers all differ
        _, st = call(http.port, "GET", "/rollout/status")
        assert st["stagePct"] == pct and st["verdict"] is None
        assert st["arms"]["candidate"]["requests"] > 0
        assert st["arms"]["active"]["requests"] > 0
        assert st["shadow"]["samples"] > 0
        _, m = call(http.port, "GET", "/metrics.json")
        # each shadow sample's predict is timed on the "shadow" span
        assert m["spans"]["shadow"]["count"] >= st["shadow"]["samples"]
        _, ready = call(http.port, "GET", "/readyz")
        assert ready["checks"]["rollout"]["stagePct"] == pct

        canary_user = next(f"u{u}" for u in range(N_USERS)
                           if in_canary(f"u{u}", pct))
        with chaos.inject("rollout.guard", error=1.0):
            code, _ = call(http.port, "POST", "/queries.json",
                           {"user": canary_user, "num": 5})
            assert code == 200          # the breach never 5xxes traffic
        _, st = call(http.port, "GET", "/rollout/status")
        assert st["verdict"] == VERDICT_ROLLED_BACK
        assert st["stagePct"] == 0
        assert "chaos" in st["reason"] or "guard" in st["reason"]
        for u in range(N_USERS):
            uid = f"u{u}"
            code, got = call(http.port, "POST", "/queries.json",
                             {"user": uid, "num": 5})
            assert code == 200
            assert got == qs_a.query({"user": uid, "num": 5})
        record = load_record(storage, iid_b)
        assert record.verdict == VERDICT_ROLLED_BACK
        assert record.baseline_instance_id == iid_a
        assert record.evidence
        # neither /reload nor a restart auto-advances onto it
        code, out = call(http.port, "POST", "/reload")
        assert code == 200 and out["engineInstanceId"] == iid_a
        qs2 = oracle(storage, engine, ep, ctx, None)
        try:
            assert qs2.instance.id == iid_a
        finally:
            qs2.close()
    finally:
        http.stop()
        qs.close()
        qs_a.close()
        qs_b.close()


def test_promote_reaches_100_and_survives_restart(two_instances):
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a)
    qs_b = oracle(storage, engine, ep, ctx, iid_b)
    try:
        code, out = call(http.port, "POST", "/rollout/deploy", {"pct": 25})
        assert code == 200, out
        code, out = call(http.port, "POST", "/rollout/promote")
        assert code == 200, out
        assert out["rollout"]["verdict"] == VERDICT_PROMOTED
        assert out["rollout"]["stagePct"] == 100
        for u in range(N_USERS):
            uid = f"u{u}"
            code, got = call(http.port, "POST", "/queries.json",
                             {"user": uid, "num": 5})
            assert code == 200
            assert got == qs_b.query({"user": uid, "num": 5})
        assert load_record(storage, iid_b).verdict == VERDICT_PROMOTED
        qs2 = oracle(storage, engine, ep, ctx, None)
        try:
            assert qs2.instance.id == iid_b
        finally:
            qs2.close()
    finally:
        http.stop()
        qs.close()
        qs_b.close()


def test_deploy_conflicts_and_promote_without_rollout(two_instances):
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a)
    try:
        assert call(http.port, "POST", "/rollout/promote")[0] == 409
        assert call(http.port, "POST", "/rollout/rollback")[0] == 409
        assert call(http.port, "GET", "/rollout/status") == (
            200, {"active": False})
        code, out = call(http.port, "POST", "/rollout/deploy", {"pct": 10})
        assert code == 200, out
        assert call(http.port, "POST", "/rollout/deploy",
                    {"pct": 20})[0] == 409      # one rollout at a time
        code, out = call(http.port, "POST", "/rollout/rollback",
                         {"reason": "drill over"})
        assert code == 200
        assert out["rollout"]["verdict"] == VERDICT_ROLLED_BACK
        # the same instance is no longer eligible as a candidate
        code, out = call(http.port, "POST", "/rollout/deploy", {"pct": 10})
        assert code == 409, out
        assert call(http.port, "POST", "/rollout/deploy",
                    {"pct": 0})[0] == 400
    finally:
        http.stop()
        qs.close()


def test_rollout_routes_are_guarded_by_the_server_key(two_instances):
    storage, engine, ep, ctx, iid_a, _ = two_instances
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a,
                            server_key=KEY)
    try:
        for path in ("/rollout/deploy", "/rollout/promote",
                     "/rollout/rollback"):
            assert call(http.port, "POST", path, {"pct": 10})[0] == 401
        assert call(http.port, "GET", "/rollout/status")[0] == 200
        code, out = call(http.port, "POST", "/rollout/deploy", {"pct": 10},
                         accessKey=KEY)
        assert code == 200, out
    finally:
        http.stop()
        qs.close()


def test_auto_ramp_advances_stages_while_green(two_instances):
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a)
    try:
        code, out = call(http.port, "POST", "/rollout/deploy",
                         {"auto": True, "stages": [50, 100],
                          "minStageSamples": 3, "minStageSeconds": 0.0,
                          "checkEvery": 1, "shadowEvery": 0,
                          "tickIntervalS": 0,
                          "guards": {"minSamples": 1000}})
        assert code == 200, out
        canary_users = [f"u{u}" for u in range(N_USERS)
                        if in_canary(f"u{u}", 50)]
        assert len(canary_users) >= 3
        for uid in canary_users:
            call(http.port, "POST", "/queries.json", {"user": uid, "num": 5})
        _, st = call(http.port, "GET", "/rollout/status")
        assert st["stagePct"] == 100 and st["verdict"] is None
        assert call(http.port, "POST", "/rollout/rollback")[0] == 200
    finally:
        http.stop()
        qs.close()


def test_all_error_candidate_rolls_back_without_ticker(two_instances):
    """The error_rate guard fires from ERRORED candidate requests alone:
    in fixed-pct mode there is no ticker, so observe() is the only
    trigger."""
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a)
    try:
        ctl = RolloutController.begin(
            storage, qs, iid_b,
            RolloutConfig(stages=(50,), shadow_every=0, check_every=1,
                          guards=GuardConfig(min_samples=5)))
        for i in range(6):
            ctl.observe("candidate", {"user": f"u{i}", "num": 3}, None,
                        0.01, error=True)
        assert ctl.verdict == VERDICT_ROLLED_BACK
        assert "error_rate" in ctl.reason
        assert load_record(storage, iid_b).verdict == VERDICT_ROLLED_BACK
        assert qs.candidate is None
    finally:
        http.stop()
        qs.close()


# -- fold-in interplay -------------------------------------------------------

def test_foldin_applies_to_both_arms(two_instances):
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a)
    try:
        code, _ = call(http.port, "POST", "/rollout/deploy", {"pct": 50})
        assert code == 200
        row = [0.5, -0.25, 0.125, 1.0]
        item = [0.25, 0.5, -1.0, 2.0]
        out = qs.foldin_upsert({"brand-new-user": row}, items={"i3": item})
        assert out["applied"] == 1 and out["new"] == 1
        assert out["itemsApplied"] == 1
        assert out["candidateQueued"] == 0      # landed on BOTH arms
        for arm in ("active", "candidate"):
            got = qs.shadow_predict({"user": "brand-new-user", "num": 3},
                                    arm)
            assert got["itemScores"], f"arm {arm} did not serve the row"
            models = (qs.models if arm == "active"
                      else qs.candidate.models)
            m = models[0]
            assert m.factors.item_factors[m.items.index_of("i3")].tolist() \
                == item
        assert qs.foldin_status()["candidateQueued"] == 0
        # a rank mismatch on the candidate queues the rows, never raises
        qs.candidate.models[0].factors.user_factors = \
            qs.candidate.models[0].factors.user_factors[:, :3]
        out = qs.foldin_upsert({"another": row})
        assert out["candidateQueued"] == 1
        assert qs.foldin_status()["candidateQueued"] == 1
    finally:
        http.stop()
        qs.close()


def test_rollback_during_inflight_foldin_keeps_active_bit_identical(
        two_instances):
    """A rollback landing mid-`foldin_upsert` leaves the active arm
    bit-identical to its pre-canary state for every untouched user — the
    rows either apply cleanly on the active arm or raise for the folder
    to retry, never a mixed/partial swap."""
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a)
    try:
        model = qs.models[0]
        pre = model.factors.user_factors.numpy().copy()
        folded_uid = "u0"
        fold_idx = model.users.index_of(folded_uid)
        row = [2.0, 2.0, 2.0, 2.0]
        for it in range(10):
            ctl = RolloutController.begin(
                storage, qs, iid_b,
                RolloutConfig(stages=(30,), shadow_every=0))
            errors: list = []

            def fold():
                try:
                    qs.foldin_upsert({folded_uid: row})
                except ValueError as e:
                    errors.append(e)    # acceptable: folder replays

            t = threading.Thread(target=fold)
            t.start()
            ctl.rollback(reason="race drill")
            t.join(timeout=30)
            assert not t.is_alive()
            assert qs.candidate is None
            now = qs.models[0].factors.user_factors.numpy()
            mask = np.ones(len(pre), dtype=bool)
            mask[fold_idx] = False
            assert np.array_equal(now[:len(pre)][mask], pre[mask]), \
                f"iteration {it} corrupted untouched active rows"
            assert (np.array_equal(now[fold_idx], np.asarray(
                row, np.float32))
                or (errors and np.array_equal(now[fold_idx],
                                              pre[fold_idx])))
            # reset the record so the next iteration can re-canary B
            save_record(storage, RolloutRecord(
                instance_id=iid_b, baseline_instance_id=iid_a,
                stages=(30,), stage_pct=100, verdict=VERDICT_PROMOTED))
    finally:
        http.stop()
        qs.close()


# -- /reload, abandoned records, the verbs -----------------------------------

def test_post_reload_canonical_get_alias(two_instances):
    storage, engine, ep, ctx, iid_a, _ = two_instances
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a)
    try:
        code, out = call(http.port, "POST", "/reload")
        assert code == 200 and out["engineInstanceId"]
        code, out = call(http.port, "GET", "/reload")  # deprecated alias
        assert code == 200 and out["engineInstanceId"]
    finally:
        http.stop()
        qs.close()


def test_rollback_concludes_abandoned_inflight_record(two_instances):
    """A process that died mid-canary left an IN_FLIGHT record no
    controller owns: a restart stays on the baseline, and `rollback`
    against the fresh process concludes it instead of answering 409
    forever."""
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    save_record(storage, RolloutRecord(
        instance_id=iid_b, baseline_instance_id=iid_a,
        stages=(5,), stage_pct=5, verdict=VERDICT_IN_FLIGHT))
    http, qs = serve_pinned(storage, engine, ep, ctx, None)
    try:
        assert qs.instance.id == iid_a
        code, out = call(http.port, "POST", "/rollout/rollback",
                         {"reason": "operator cleanup"})
        assert code == 200, out
        assert out["instanceId"] == iid_b
        assert out["verdict"] == VERDICT_ROLLED_BACK
        record = load_record(storage, iid_b)
        assert record.verdict == VERDICT_ROLLED_BACK
        assert "abandoned" in record.reason
        assert call(http.port, "POST", "/rollout/rollback")[0] == 409
    finally:
        http.stop()
        qs.close()


def _cli(*argv) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "pio_tpu_torch", *argv],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=REPO)


def test_cli_canary_promote_rollback_verbs(two_instances):
    """``deploy --canary``, ``promote`` and ``rollback`` as processes
    against a running deploy server, with its server key."""
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a,
                            server_key=KEY)
    try:
        port = str(http.port)
        out = _cli("deploy", "--canary", "15", "--ip", "127.0.0.1",
                   "--port", port)
        assert out.returncode == 1 and "401" in out.stderr
        out = _cli("deploy", "--canary", "15", "--ip", "127.0.0.1",
                   "--port", port, "--server-key", KEY)
        assert out.returncode == 0, out.stderr
        st = json.loads(out.stdout)["rollout"]
        assert st["stagePct"] == 15 and st["candidateInstanceId"] == iid_b
        out = _cli("rollback", "--port", port, "--server-key", KEY,
                   "--reason", "cli drill")
        assert out.returncode == 0, out.stderr
        st = json.loads(out.stdout)["rollout"]
        assert st["verdict"] == VERDICT_ROLLED_BACK
        assert st["reason"] == "cli drill"
        # nothing in flight: promote is a clean error, not a traceback
        out = _cli("promote", "--port", port, "--server-key", KEY)
        assert out.returncode == 1 and "409" in out.stderr
        assert _cli("deploy", "--canary", "nope",
                    "--port", port).returncode == 1
        assert _cli("deploy", "--canary", "10", "--from-eval", "latest",
                    "--port", port).returncode == 1
        # auto with its stage knobs, pinned to an instance; then promote
        save_record(storage, RolloutRecord(
            instance_id=iid_b, baseline_instance_id=iid_a, stages=(1,),
            stage_pct=100, verdict=VERDICT_PROMOTED))
        out = _cli("deploy", "--canary", "auto", "--engine-instance-id",
                   iid_b, "--canary-min-stage-seconds", "0",
                   "--canary-min-stage-samples", "1", "--port", port,
                   "--server-key", KEY)
        assert out.returncode == 0, out.stderr
        st = json.loads(out.stdout)["rollout"]
        assert st["auto"] and st["stages"] == [1, 5, 25, 100]
        out = _cli("promote", "--port", port, "--server-key", KEY)
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout)["rollout"]["verdict"] == \
            VERDICT_PROMOTED
        assert qs.instance.id == iid_b
    finally:
        http.stop()
        qs.close()


@pytest.mark.parametrize("verdict", [VERDICT_ROLLED_BACK, VERDICT_IN_FLIGHT])
def test_a_rejected_canary_is_never_auto_loaded(two_instances, tmp_path,
                                                verdict):
    """With the newer instance's canary rolled back (or still in
    flight), the deploy and the fold-in worker both take the older one,
    at start and after /reload."""
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    save_record(storage, RolloutRecord(
        instance_id=iid_b, baseline_instance_id=iid_a, stages=(25,),
        stage_pct=0 if verdict == VERDICT_ROLLED_BACK else 25,
        verdict=verdict))

    class Sink:
        def apply(self, rows, staleness_s=None):
            return {"applied": len(rows)}

    worker = FoldInWorker(storage, FoldInConfig(
        app_name="mlapp", engine_id="rec",
        als_params=als.ALSParams(rank=4, reg=0.05),
        state_path=str(tmp_path / "cursor.bin")), Sink(), device="cpu")
    http, qs = serve_pinned(storage, engine, ep, ctx, None,
                            server_key=KEY)
    try:
        assert qs.instance.id == iid_a
        worker.run_once()
        assert worker.snapshot()["modelInstanceId"] == iid_a
        code, out = call(http.port, "POST", "/reload", accessKey=KEY)
        assert code == 200 and out["engineInstanceId"] == iid_a
        worker.run_once()
        assert worker.snapshot()["modelInstanceId"] == iid_a
        # a pinned id still loads whatever its record says
        qs_b = oracle(storage, engine, ep, ctx, iid_b)
        assert qs_b.instance.id == iid_b
        qs_b.close()
        # with every instance rejected, a reload fails and keeps serving
        save_record(storage, RolloutRecord(
            instance_id=iid_a, baseline_instance_id=iid_a, stages=(25,),
            stage_pct=0, verdict=VERDICT_ROLLED_BACK))
        code, out = call(http.port, "POST", "/reload", accessKey=KEY)
        assert code == 503 and out["engineInstanceId"] == iid_a
        assert "eligible" in out["message"]
    finally:
        http.stop()
        qs.close()


# -- both arms through the batchers, against the JAX package -----------------

N_SEEDED, N_ITEMS, RANK = 40, 600, 8
MODES = {"continuous": {"coalesce_window_ms": 60.0},
         "micro": {"batch_window_ms": 25.0}}


@pytest.fixture(scope="module")
def seeded_arms(tmp_path_factory):
    """Two seeded factor sets persisted as instances A and B in a sqlite
    store of each package; the port's solo QueryServer of each (the
    oracles) and the JAX one of each."""
    root = tmp_path_factory.mktemp("arms")
    rng = np.random.default_rng(23)
    users = [f"u{i}" for i in range(N_SEEDED)]
    items = [f"i{i}" for i in range(N_ITEMS)]
    factors = [(rng.standard_normal((N_SEEDED, RANK)).astype(np.float32),
                rng.standard_normal((N_ITEMS, RANK)).astype(np.float32))
               for _ in range(2)]
    variant = {"id": "rec", "engineFactory": FACTORY,
               "algorithms": [{"name": "als", "params": {"rank": RANK}}]}
    (root / "port").mkdir()
    (root / "ref").mkdir()
    storage = Storage(env=_env(root / "port"))
    engine = port_rec.RecommendationEngine.apply()
    ep = engine.engine_params_from_variant(variant)
    ctx = create_workflow_context(storage, device="cpu")
    ref_store = RefStorage(env=_env(root / "ref"))
    ref_engine = ref_rec.RecommendationEngine.apply()
    ref_ep = ref_engine.engine_params_from_variant(
        {**variant, "engineFactory":
         "pio_tpu.models.recommendation.RecommendationEngine"})
    iids, solo, ref = [], [], []
    for uf, itf in factors:
        iid = persist_models([recommendation_model_from_numpy(
            uf, itf, users, items, device="cpu")], ep, storage, "rec",
            engine_factory=FACTORY)
        iids.append(iid)
        solo.append(oracle(storage, engine, ep, ctx, iid))
        ref_iid = ref_store.get_metadata_engine_instances().insert(
            RefEngineInstance(
                id="", status="COMPLETED", start_time=T0, end_time=T0,
                engine_id="rec", engine_version="1",
                engine_variant="default",
                engine_factory="pio_tpu.models.recommendation"
                               ".RecommendationEngine"))
        ref_store.get_model_data_models().insert(RefModel(
            ref_iid, ref_models_to_bytes([ref_rec.RecommendationModel(
                ref_als.ALSModel(jnp.asarray(uf), jnp.asarray(itf)),
                RefIdIndex(users), RefIdIndex(items))])))
        ref.append(RefQueryServer(
            ref_engine, ref_ep, ref_store,
            RefServingConfig(ip="127.0.0.1", port=0, engine_id="rec"),
            ctx=ref_ctx(ref_store, use_mesh=False), instance_id=ref_iid))
    yield storage, engine, ep, ctx, iids, solo, ref
    for qs in solo + ref:
        qs.close()
    storage.close()
    ref_store.close()


def _concurrently(fn, n):
    """``fn(i)`` for i < n on n threads that start it together: a thread
    still being created must not arrive after the others' batch left."""
    out = [None] * n
    start = threading.Barrier(n)

    def one(i):
        start.wait(timeout=60)
        out[i] = fn(i)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_arms_through_the_batchers_equal_solo_and_count_once(seeded_arms,
                                                             mode):
    """Both arms stay bit-identical to their instance's solo answers
    through either batcher (the per-arm sub-batches run at the dispatch
    rows), their ids are the JAX package's, and every query counts ONCE
    in its arm's stats and once in its arm's dispatches' rows."""
    storage, engine, ep, ctx, (iid_a, iid_b), solo, ref = seeded_arms
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a,
                            server_key=KEY, **MODES[mode])
    try:
        pct = 40
        code, out = call(http.port, "POST", "/rollout/deploy",
                         {"pct": pct, "instanceId": iid_b,
                          "shadowEvery": 10 ** 9, "checkEvery": 10 ** 9},
                         accessKey=KEY)
        assert code == 200, out
        queries = [{"user": f"u{u}", "num": 5} for u in range(N_SEEDED)]
        queries[3]["blackList"] = ["i1", "i2"]
        queries[4] = {"user": "ghost", "num": 4}     # unknown: active arm
        results = _concurrently(lambda i: call(
            http.port, "POST", "/queries.json", queries[i]), len(queries))
        n_canary = 0
        for q, (status, body) in zip(queries, results):
            assert status == 200, (q, body)
            canary = in_canary(q["user"], pct)
            n_canary += canary
            arm = 1 if canary else 0
            assert body == json.loads(json.dumps(
                solo[arm].query(dict(q), record=False))), q
            want = ref[arm].query(dict(q), record=False)
            assert [s["item"] for s in body["itemScores"]] == \
                [s["item"] for s in want["itemScores"]], q
            np.testing.assert_allclose(
                [s["score"] for s in body["itemScores"]],
                [s["score"] for s in want["itemScores"]],
                rtol=RTOL, atol=ATOL)
        assert 0 < n_canary < len(queries)
        _, st = call(http.port, "GET", "/rollout/status")
        assert st["arms"]["candidate"]["requests"] == n_canary
        assert st["arms"]["active"]["requests"] == len(queries) - n_canary
        _, m = call(http.port, "GET", "/metrics.json")
        d = m["armDispatches"]
        assert 1 <= d["candidate"] <= n_canary
        assert 1 <= d["active"] <= len(queries) - n_canary
        assert d["active"] + d["candidate"] < len(queries)   # batched
        _, b = call(http.port, "GET", "/batcher.json")
        assert b["enabled"] and b["mode"] == mode
    finally:
        http.stop()
        qs.close()


def test_failed_batch_retries_count_once(seeded_arms):
    """A batch whose candidate sub-batch fails records nothing of itself
    when its caller retries each query solo, so every query counts once
    (the retry's): neither the failed arm's members nor the active
    members answered before the failure count again. Without a retry
    (the bulk route) the failed arm's members count as errors and the
    active ones as served."""
    storage, engine, ep, ctx, (iid_a, iid_b), _, _ = seeded_arms
    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a,
                            coalesce_window_ms=60.0)
    try:
        ctl = RolloutController.begin(
            storage, qs, iid_b, RolloutConfig(
                stages=(50,), shadow_every=0, check_every=10 ** 9))

        def fall_over(model, queries):
            raise RuntimeError("device fell over")

        qs.candidate.algorithms[0].batch_predict = fall_over
        queries = [{"user": f"u{u}", "num": 3} for u in range(12)]
        n_cand = sum(in_canary(q["user"], 50) for q in queries)
        assert 0 < n_cand < len(queries)

        def arms():
            st = ctl.status()["arms"]
            return [(st[a]["requests"], st[a]["errors"])
                    for a in ("active", "candidate")]

        with pytest.raises(RuntimeError):
            qs.query_batch(queries, observe_batch_errors=False)
        assert arms() == [(0, 0), (0, 0)]
        with pytest.raises(RuntimeError):
            qs.query_batch(queries)
        assert arms() == [(12 - n_cand, 0), (n_cand, n_cand)]
        out = _concurrently(lambda i: call(
            http.port, "POST", "/queries.json", queries[i]), len(queries))
        assert all(s == 200 for s, _ in out)
        assert arms() == [(2 * (12 - n_cand), 0), (2 * n_cand, n_cand)]
    finally:
        http.stop()
        qs.close()


def test_rejecting_blocker_in_a_batch_counts_once(seeded_arms):
    """An output blocker that rejects a candidate member fails its batch
    after both arms answered. Nothing of the batch is recorded: no arm's
    stats, no feedback event. The coalescer's solo retries then count
    every member once in its arm's stats and write one ``predict`` event
    for each answered member and none for the rejected one."""
    storage, engine, ep, ctx, (iid_a, iid_b), _, _ = seeded_arms
    app_id = storage.get_metadata_apps().insert(App(0, "blocked-batch"))
    storage.get_events().init(app_id)
    queries = [{"user": f"u{u}", "num": 3} for u in range(12)]
    n_cand = sum(in_canary(q["user"], 50) for q in queries)
    assert 0 < n_cand < len(queries)
    rejected = next(q["user"] for q in queries if in_canary(q["user"], 50))

    class RejectOne(EngineServerPlugin):
        plugin_name = "reject-one"
        plugin_type = EngineServerPlugin.OUTPUT_BLOCKER

        def process(self, query, prediction, context):
            if query["user"] == rejected:
                raise PluginRejection(f"{rejected} rejected")
            return prediction

    http, qs = serve_pinned(storage, engine, ep, ctx, iid_a,
                            plugin_context=PluginContext([RejectOne()]),
                            coalesce_window_ms=60.0, feedback=True,
                            feedback_app_name="blocked-batch")
    try:
        ctl = RolloutController.begin(
            storage, qs, iid_b, RolloutConfig(
                stages=(50,), shadow_every=0, check_every=10 ** 9))

        def arms():
            st = ctl.status()["arms"]
            return [(st[a]["requests"], st[a]["errors"])
                    for a in ("active", "candidate")]

        def events():
            return list(storage.get_events().find(
                app_id, entity_type="pio_pr", limit=-1))

        with pytest.raises(PluginRejection):
            qs.query_batch(queries, observe_batch_errors=False)
        assert arms() == [(0, 0), (0, 0)]
        out = _concurrently(lambda i: call(
            http.port, "POST", "/queries.json", queries[i]), len(queries))
        assert [s == 200 for s, _ in out] == \
            [q["user"] != rejected for q in queries]
        # the rejected member was served, then refused by the blocker
        assert arms() == [(12 - n_cand, 0), (n_cand, 0)]
        deadline = time.monotonic() + 10
        while len(events()) < 11 and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.2)   # a duplicate would land on a detached thread too
        found = events()
        assert sorted(e.properties["query"]["user"] for e in found) == \
            sorted(q["user"] for q in queries if q["user"] != rejected)
        assert all(e.event == "predict" for e in found)
    finally:
        http.stop()
        qs.close()


def test_batched_queries_are_charged_their_dispatch_wall(seeded_arms):
    """ROADMAP C13: each query of a mixed batch is charged the wall time of
    its arm's sub-batch, as a solo query is charged its own, not that wall
    over the sub-batch's size. With a fixed cost a dispatch (a 20 ms
    delay on either arm), a batch of 11 active queries and one candidate
    query charges both arms at least 20 ms a query, and the latency guard
    (candidate mean over active mean, at most 3.0) stays green, where the
    wall over the size charged the active arm under 2 ms a query."""
    storage, engine, ep, ctx, (iid_a, iid_b), _, _ = seeded_arms
    qs = oracle(storage, engine, ep, ctx, iid_a)
    delay_s = 0.02
    try:
        ctl = RolloutController.begin(
            storage, qs, iid_b, RolloutConfig(
                stages=(50,), shadow_every=0, check_every=10 ** 9))
        users = [f"u{u}" for u in range(N_SEEDED)]
        cand = next(u for u in users if in_canary(u, 50))
        queries = [{"user": u, "num": 3}
                   for u in users if not in_canary(u, 50)][:11]
        queries.append({"user": cand, "num": 3})
        for arm in (ARM_ACTIVE, ARM_CANDIDATE):
            algo = qs._arm_snapshot(arm)[1][0]

            def slow(model, qs_, _predict=algo.batch_predict):
                time.sleep(delay_s)
                return _predict(model, qs_)

            algo.batch_predict = slow
        for _ in range(3):
            qs.query_batch(queries)
        st = ctl.status()
        active = st["arms"]["active"]
        candidate = st["arms"]["candidate"]
        assert (active["requests"], candidate["requests"]) == (33, 3)
        assert active["meanLatencySeconds"] >= delay_s
        assert candidate["meanLatencySeconds"] >= delay_s
        assert (candidate["meanLatencySeconds"]
                <= 3.0 * active["meanLatencySeconds"])
    finally:
        qs.close()


# -- the fleet's rollout: the router carries the split -----------------------

def _query_all(port, oracle_of):
    """Every user through the router: 200, and the body of the
    single-host deploy of the arm ``oracle_of(uid)`` names, bit for
    bit."""
    for u in range(N_USERS):
        uid = f"u{u}"
        code, got = call(port, "POST", "/queries.json",
                         {"user": uid, "num": 5})
        assert code == 200, got
        want = oracle_of(uid).query({"user": uid, "num": 5}, record=False)
        assert got == json.loads(json.dumps(want)), f"user {uid}"


@pytest.mark.usefixtures("time_limit")
def test_fleet_canary_sticky_split_and_promote(two_instances, capsys):
    """``deploy --canary 40`` and ``promote`` against a fleet router: the
    router carries the single host's sticky split over the candidate
    partitions (each user's body its arm's single-host answer), every
    replica stages the candidate, and promote makes the candidate's plan
    the fleet's, its verdict persisted."""
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=1, instance_id=iid_a, device="cpu",
                          server_key=KEY)
    qs_a = oracle(storage, engine, ep, ctx, iid_a)
    qs_b = oracle(storage, engine, ep, ctx, iid_b)
    try:
        port = handle.router_http.port
        pct = 40
        assert port_main(["deploy", "--canary", str(pct), "--port",
                          str(port), "--server-key", KEY]) == 0
        st = json.loads(capsys.readouterr().out)["rollout"]
        assert st["candidateInstanceId"] == iid_b
        assert st["baselineInstanceId"] == iid_a
        assert st["stagePct"] == pct
        _query_all(port, lambda uid: qs_b if in_canary(uid, pct) else qs_a)
        for http, _srv in handle.shards:
            _, info = call(http.port, "GET", "/shard/info")
            assert info["candidateInstanceId"] == iid_b
        _, status = call(port, "GET", "/rollout/status")
        assert status["arms"]["candidate"]["requests"] == sum(
            in_canary(f"u{u}", pct) for u in range(N_USERS))
        assert port_main(["promote", "--port", str(port),
                          "--server-key", KEY]) == 0
        st = json.loads(capsys.readouterr().out)["rollout"]
        assert st["verdict"] == VERDICT_PROMOTED and st["stagePct"] == 100
        _, fleet = call(port, "GET", "/fleet.json")
        assert fleet["plan"]["instanceId"] == iid_b
        _query_all(port, lambda uid: qs_b)
        assert load_record(storage, iid_b).verdict == VERDICT_PROMOTED
    finally:
        handle.close()
        qs_a.close()
        qs_b.close()


@pytest.mark.usefixtures("time_limit")
def test_fleet_corrupt_candidate_blob_auto_rolls_back(two_instances):
    """One shard group's candidate blob corrupt: the staged load fails,
    the rollout rolls back by itself with its verdict persisted, no
    query is answered by the bad arm, no replica keeps a candidate, and
    a fleet /reload stays on A."""
    storage, engine, ep, ctx, iid_a, iid_b = two_instances
    handle = deploy_fleet(storage, engine_id="rec", n_shards=2,
                          n_replicas=2, instance_id=iid_a, device="cpu")
    qs_a = oracle(storage, engine, ep, ctx, iid_a)
    try:
        port = handle.router_http.port
        _, model_b = resolve_fleet_model(storage, "rec", instance_id=iid_b)
        persist_fleet_artifacts(storage, iid_b, model_b, 2, 2)
        models = storage.get_model_data_models()
        good = bytearray(models.get(shard_model_id(iid_b, 1)).models)
        good[len(good) // 2] ^= 0xFF
        models.insert(Model(shard_model_id(iid_b, 1), bytes(good)))

        code, out = call(port, "POST", "/rollout/deploy", {"pct": 30})
        assert code == 503, out
        assert out["verdict"] == VERDICT_ROLLED_BACK
        record = load_record(storage, iid_b)
        assert record.verdict == VERDICT_ROLLED_BACK
        assert "load failed" in record.reason
        _query_all(port, lambda uid: qs_a)
        _, fleet = call(port, "GET", "/fleet.json")
        for group in fleet["shards"].values():
            for rep in group["replicas"]:
                assert rep["candidateInstanceId"] is None
        code, out = call(port, "POST", "/reload")
        assert code == 200
        assert out["planInstanceId"] == iid_a
    finally:
        handle.close()
        qs_a.close()
