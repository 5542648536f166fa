"""The port's columnar event read against the JAX package's, on sqlite.

The same seeded events go into a database written by the reference's
storage and another written by the port's. ``EventStore.interactions``
of both must be equal element for element (ids, indexes, values and
their dtypes) under every dedup mode, ``value_event``, a time window, a
channel and events without a target. In one database the port's
``columnarize`` must equal its own ``find`` + fold
(``columnarize_via_find``, time ties included), and ``find_columnar``
must equal the reference's columns. No tolerance: the folds are exact.
"""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from pio_tpu.data.dao import App as RefApp
from pio_tpu.data.dao import Channel as RefChannel
from pio_tpu.data.event import Event as RefEvent
from pio_tpu.data.eventstore import EventStore as RefEventStore
from pio_tpu.data.storage import Storage as RefStorage
from pio_tpu_torch.data.dao import App, Channel
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.data.eventstore import (
    EventStore,
    columnarize_via_find,
    interactions_to_columns,
)
from pio_tpu_torch.data.storage import Storage
from pio_tpu_torch.native.eventlog import Columns

APP, CHANNEL = "ColApp", "side"
T0 = datetime(2024, 1, 1, tzinfo=timezone.utc)


def _env(path):
    return {"PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
            "PIO_STORAGE_SOURCES_SQL_PATH": str(path),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQL",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"}


def _rows(seed=0, n=600, ties=False):
    """(event, user, item or None, rating or None, seconds, channel?)
    rows: rate/buy/view events, re-rated pairs, events without a target
    and a share in the side channel. Without ``ties`` every event has its
    own time, so two databases order them alike."""
    rng = np.random.default_rng(seed)
    secs = (rng.integers(0, n // 4, n) if ties
            else rng.permutation(n)).tolist()
    out = []
    for j in range(n):
        kind = str(rng.choice(["rate", "buy", "view"], p=[0.6, 0.3, 0.1]))
        item = None if rng.random() < 0.08 else f"i{rng.integers(0, 25)}"
        rating = float(rng.integers(1, 6)) if kind == "rate" else None
        out.append((kind, f"u{rng.integers(0, 30)}", item, rating, secs[j],
                    bool(rng.random() < 0.2)))
    return out


def _write(storage, event_cls, app_cls, channel_cls, rows):
    app_id = storage.get_metadata_apps().insert(app_cls(0, APP))
    ch_id = storage.get_metadata_channels().insert(
        channel_cls(0, CHANNEL, app_id))
    events = storage.get_events()
    events.init(app_id)
    events.init(app_id, ch_id)
    main, side = [], []
    for kind, user, item, rating, sec, in_side in rows:
        e = event_cls(
            event=kind, entity_type="user", entity_id=user,
            target_entity_type="item" if item else None,
            target_entity_id=item,
            properties={"rating": rating} if rating is not None else {},
            event_time=T0 + timedelta(seconds=sec))
        (side if in_side else main).append(e)
    events.insert_batch(main, app_id)
    events.insert_batch(side, app_id, ch_id)
    return app_id, ch_id


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    d = tmp_path_factory.mktemp("columnar")
    rows = _rows()
    port = Storage(env=_env(d / "port.db"))
    ref = RefStorage(env=_env(d / "ref.db"))
    _write(port, Event, App, Channel, rows)
    _write(ref, RefEvent, RefApp, RefChannel, rows)
    yield port, ref
    port.close()
    ref.close()


_READS = {
    "last": dict(dedup="last"),
    "sum": dict(dedup="sum"),
    "none": dict(dedup="none"),
    "value_event": dict(value_event="rate", default_value=4.0),
    "no_value_key": dict(value_key=None, default_value=2.5),
    "window": dict(start_time=T0 + timedelta(seconds=100),
                   until_time=T0 + timedelta(seconds=400)),
    "channel": dict(channel_name=CHANNEL, value_event="rate"),
    "no_target_filter": dict(target_entity_type=..., event_names=None),
}


def _kwargs(case):
    kw = dict(app_name=APP, entity_type="user", target_entity_type="item",
              event_names=["rate", "buy"])
    kw.update(_READS[case])
    return kw


def _assert_same(got, want):
    assert got.users.ids() == want.users.ids()
    assert got.items.ids() == want.items.ids()
    for name in ("user_idx", "item_idx", "values"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", sorted(_READS))
def test_interactions_equal_the_reference(stores, case):
    port, ref = stores
    got = EventStore(port).interactions(**_kwargs(case))
    want = RefEventStore(ref).interactions(**_kwargs(case))
    assert len(got) > 0
    _assert_same(got, want)


@pytest.mark.parametrize("dedup", ["last", "sum", "none"])
def test_columnarize_equals_find_and_fold_with_time_ties(tmp_path, dedup):
    port = Storage(env=_env(tmp_path / "ties.db"))
    try:
        app_id, ch_id = _write(port, Event, App, Channel,
                               _rows(seed=1, ties=True))
        dao = port.get_events()
        for channel in (None, ch_id):
            kw = dict(channel_id=channel, entity_type="user",
                      event_names=["rate", "buy", "view"],
                      value_event="rate", default_value=3.0, dedup=dedup)
            cols = dao.columnarize(app_id, **kw)
            want = columnarize_via_find(dao, app_id, **kw)
            assert cols.users == want.users.ids()
            assert cols.items == want.items.ids()
            np.testing.assert_array_equal(cols.user_idx, want.user_idx)
            np.testing.assert_array_equal(cols.item_idx, want.item_idx)
            np.testing.assert_array_equal(cols.values, want.values)
            back = interactions_to_columns(want)
            assert isinstance(back, Columns)
            np.testing.assert_array_equal(back.user_idx, cols.user_idx)
            assert back.user_idx.dtype == cols.user_idx.dtype == np.uint32
    finally:
        port.close()


@pytest.mark.parametrize("channel", [False, True])
def test_find_columnar_equals_the_reference(stores, channel):
    port, ref = stores

    def cols(storage):
        app = storage.get_metadata_apps().get_by_name(APP)
        ch = storage.get_metadata_channels().get_by_appid(app.id)[0].id
        return storage.get_events().find_columnar(
            app.id, channel_id=ch if channel else None, entity_type="user",
            event_names=["rate", "buy", "view"])

    got, want = cols(port), cols(ref)
    assert len(got) == len(want) > 0
    for name in ("event_code", "entity_code", "target_code", "time_us",
                 "tz_min"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("event_names", "entity_ids", "target_ids"):
        assert getattr(got, name) == getattr(want, name)
    assert [got.props(i) for i in range(len(got))] == \
        [want.props(i) for i in range(len(want))]


def test_interactions_without_columnarize_take_the_row_fold(stores):
    """A DAO without ``columnarize`` (a duck-typed third-party one) gets
    the row fold, with the same result."""
    port, _ = stores

    class RowOnly:
        def __init__(self, dao):
            self.find = dao.find

    class RowStore(EventStore):
        def _dao(self):
            return RowOnly(self.storage.get_events())

    kw = _kwargs("value_event")
    _assert_same(RowStore(port).interactions(**kw),
                 EventStore(port).interactions(**kw))


def test_aggregate_properties_equal_the_reference(tmp_path):
    port = Storage(env=_env(tmp_path / "p.db"))
    ref = RefStorage(env=_env(tmp_path / "r.db"))
    try:
        for storage, ev_cls, app_cls in ((port, Event, App),
                                         (ref, RefEvent, RefApp)):
            app_id = storage.get_metadata_apps().insert(app_cls(0, APP))
            events = storage.get_events()
            events.init(app_id)
            rng = np.random.default_rng(2)
            batch = []
            for j in range(200):
                kind = str(rng.choice(["$set", "$unset", "$delete", "rate"],
                                      p=[0.6, 0.2, 0.05, 0.15]))
                props = ({f"p{rng.integers(0, 4)}": int(rng.integers(9))}
                         if kind in ("$set", "$unset") else {})
                batch.append(ev_cls(
                    event=kind, entity_type="item",
                    entity_id=f"i{rng.integers(0, 12)}", properties=props,
                    event_time=T0 + timedelta(seconds=j)))
            events.insert_batch(batch, app_id)
        got = EventStore(port).aggregate_properties(APP, "item")
        want = RefEventStore(ref).aggregate_properties(APP, "item")
    finally:
        port.close()
        ref.close()
    assert sorted(got) == sorted(want) and got
    for eid, pm in got.items():
        assert pm.fields == want[eid].fields
        assert pm.first_updated == want[eid].first_updated
        assert pm.last_updated == want[eid].last_updated
