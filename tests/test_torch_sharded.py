"""The port's sharded event store against a single store and the
reference's.

``shard_for`` routes seeded entities as the reference's does. Over two of
the port's storage servers (each on its own memory or eventlog store),
the port's sharded ``find_columnar`` (per-shard ``/rpc/columnar`` frames
merged by ``concat_columnar``) holds the rows of one store that took the
same events, bit for bit (every event name, id, microsecond, zone and
property), and so does the reference's sharded read of the same servers;
the sharded ``columnarize`` holds its (user, item, value) triples; the
scatter ``find`` keeps time order and the limit; each shard holds the
events its hash assigns. Tolerance: exact equality.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)

import contextlib
import random
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

import pio_tpu.data.backends.sharded as ref_sharded
import pio_tpu.data.storage as ref_storage
import pio_tpu_torch.data.backends.sharded as port_sharded
import pio_tpu_torch.data.storage as port_storage
from pio_tpu_torch.data.dao import App
from pio_tpu_torch.data.datamap import DataMap
from pio_tpu_torch.data.event import Event
from tests.test_torch_storageserver import backing_env, served

T0 = datetime(2022, 3, 1, tzinfo=timezone.utc)
N_SHARDS = 2


@pytest.mark.parametrize("n_shards", [1, 2, 3, 5, 8])
def test_shard_for_equals_the_reference(n_shards):
    rng = random.Random(n_shards)
    alphabet = "abcxyz0123456789-_é日"
    entities = [(rng.choice(["user", "item", "account"]),
                 "".join(rng.choice(alphabet)
                         for _ in range(rng.randrange(1, 12))))
                for _ in range(2_000)]
    got = [port_sharded.shard_for(t, i, n_shards) for t, i in entities]
    assert got == [ref_sharded.shard_for(t, i, n_shards)
                   for t, i in entities]
    if n_shards > 1:
        assert len(set(got)) == n_shards


def events(n: int = 120) -> list:
    """Seeded events at distinct times (to the millisecond, as the JSON
    wire carries them), users and a few accounts, rated and bought
    items, some with no target."""
    rng = np.random.default_rng(3)
    out = []
    for m in range(n):
        name = ("rate", "buy", "$set")[m % 3]
        out.append(Event(
            event=name, entity_type="account" if m % 11 == 0 else "user",
            entity_id=f"u{int(rng.integers(17))}",
            target_entity_type=None if name == "$set" else "item",
            target_entity_id=None if name == "$set"
            else f"i{int(rng.integers(9))}",
            properties=DataMap({"rating": float(rng.integers(1, 6))}
                               if name == "rate" else {"n": m}),
            event_time=(T0 + timedelta(seconds=m, milliseconds=m * 7)
                        ).astimezone(timezone(timedelta(hours=m % 3))),
            event_id=f"ev{m:04d}"))
    return out


def rows(cols) -> list:
    """Each row decoded: event, entity, target, µs, zone, properties."""
    return [(cols.event_names[cols.event_code[j]],
             cols.entity_ids[cols.entity_code[j]],
             cols.target_ids[cols.target_code[j]]
             if cols.target_code[j] >= 0 else None,
             int(cols.time_us[j]), int(cols.tz_min[j]), cols.props(j))
            for j in range(len(cols))]


def triples(cols) -> list:
    return sorted(zip([cols.users[u] for u in cols.user_idx],
                      [cols.items[i] for i in cols.item_idx],
                      cols.values.tolist()))


def sharded_env(ports: list) -> dict:
    return {
        "PIO_STORAGE_SOURCES_M_TYPE": "memory",
        "PIO_STORAGE_SOURCES_SH_TYPE": "sharded",
        "PIO_STORAGE_SOURCES_SH_URLS": ",".join(
            f"http://127.0.0.1:{p}" for p in ports),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "M",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SH",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "M",
    }


@pytest.fixture(scope="module", params=["memory", "eventlog"])
def stores(request, tmp_path_factory):
    """(the port's sharded storage over two port storage servers, the
    reference's over the same servers, the servers' backing stores, one
    store holding the same events, the app id). The tests only read."""
    tmp_path = tmp_path_factory.mktemp(request.param)
    with contextlib.ExitStack() as stack:
        shards = [stack.enter_context(served(
            "port", backing_env(request.param, tmp_path / f"s{k}")))
            for k in range(N_SHARDS)]
        ports = [srv.port for srv, _ in shards]
        port = port_storage.Storage(env=sharded_env(ports))
        ref = ref_storage.Storage(env=sharded_env(ports))
        single = port_storage.Storage(
            env=backing_env(request.param, tmp_path / "single"))
        app_id = port.get_metadata_apps().insert(App(0, "shardapp"))
        assert single.get_metadata_apps().insert(App(0, "shardapp")) == app_id
        for s in (port, single):
            s.get_events().init(app_id)
        port.get_events().insert_batch(events(), app_id)
        single.get_events().insert_batch(events(), app_id)
        yield port, ref, [b for _, b in shards], single, app_id
        for s in (port, ref, single):
            s.close()


FILTERS = [{}, {"entity_type": "user", "event_names": ["rate", "buy"]},
           {"target_entity_type": None},
           {"start_time": T0 + timedelta(seconds=30),
            "until_time": T0 + timedelta(seconds=90)},
           {"entity_type": "user", "entity_id": "u3"}]


@pytest.mark.parametrize("flt", range(len(FILTERS)))
def test_sharded_find_columnar_equals_one_store(stores, flt):
    port, ref, _, single, app_id = stores
    kw = FILTERS[flt]
    want = rows(single.get_events().find_columnar(app_id, **kw))
    assert rows(port.get_events().find_columnar(app_id, **kw)) == want
    assert rows(ref.get_events().find_columnar(app_id, **kw)) == want
    assert len(want) > 0


def test_each_shard_holds_the_events_its_hash_assigns(stores):
    _, _, backings, _, app_id = stores
    for k, backing in enumerate(backings):
        held = list(backing.get_events().find(app_id, limit=-1))
        assert held
        for e in held:
            assert ref_sharded.shard_for(e.entity_type, e.entity_id,
                                         N_SHARDS) == k


@pytest.mark.parametrize("dedup", ["none", "last", "sum"])
def test_sharded_columnarize_triples_equal_one_store(stores, dedup):
    """entity_type pinned: per-shard server-side folds merged; None: the
    global find + fold (two entity types may share an id)."""
    port, ref, _, single, app_id = stores
    for entity_type in ("user", None):
        kw = dict(entity_type=entity_type, event_names=["rate", "buy"],
                  default_value=3.0, dedup=dedup, value_event="rate")
        want = triples(single.get_events().columnarize(app_id, **kw))
        assert triples(port.get_events().columnarize(app_id, **kw)) == want
        assert triples(ref.get_events().columnarize(app_id, **kw)) == want
        assert len(want) > 10


@pytest.mark.parametrize("limit,reverse", [(5, False), (17, True),
                                           (-1, False), (-1, True)])
def test_scatter_merge_keeps_time_order_and_the_limit(stores, limit,
                                                      reverse):
    port, _, _, single, app_id = stores
    kw = dict(limit=limit, reversed=reverse)
    got = [e.event_id for e in port.get_events().find(app_id, **kw)]
    want = [e.event_id for e in single.get_events().find(app_id, **kw)]
    assert got == want
    assert len(got) == (120 if limit < 0 else limit)
