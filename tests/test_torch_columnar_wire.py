"""The port's columnar wire codecs against the reference's.

Both packages encode the same seeded batches (the reference's hostile
fuzz generator: reserved names, non-string ids, tags, tz offsets, raw
fallback rows) and must produce the same bytes; each decodes the other's
frames to the same events, verdicts and messages. A hypothesis fuzz
truncates frames, flips their bits, and mutates payloads under a
recomputed CRC32C (so the structural checks behind the checksum are
reached): both decoders must raise the same ``WireFormatError`` message
or return the same result. Tolerance: exact equality throughout.
"""

from __future__ import annotations

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)

import random
from datetime import datetime, timezone

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import pio_tpu.data.columnar as ref
import pio_tpu_torch.data.columnar as port
from pio_tpu.utils.durable import frame as ref_frame, unframe as ref_unframe
from tests.test_columnar_wire import _fuzz_event

NOW = datetime(2026, 7, 30, 12, 0, 0, 123456, tzinfo=timezone.utc)
SEEDS = range(6)


def verdicts(decoded) -> list:
    """Each slot as the JSON the event server would store, or the
    failure's class name and message."""
    return [d.to_api_dict() if not isinstance(d, Exception)
            else (type(d).__name__, str(d)) for d in decoded]


def outcome(decode, blob: bytes):
    try:
        return verdicts(decode(blob, NOW))
    except Exception as e:  # noqa: BLE001 - the failure is what is compared
        return (type(e).__name__, str(e))


def batch(seed: int, n: int | None = None) -> list:
    rng = random.Random(seed)
    return [_fuzz_event(rng, i) for i in range(n or rng.randrange(1, 40))]


def read_columns(pkg, seed: int, n: int = 64):
    """A seeded read batch: per-column tables with unused entries,
    absent targets, raw-JSON and dict property entries."""
    rng = np.random.default_rng(seed)
    names = ["rate", "buy", "view", "$set"]
    ids = [f"u{j}" for j in range(9)] + ["идент", ""]
    targets = [f"i{j}" for j in range(6)]
    props = [None, '{"rating": 4}', {"rating": 2.5, "tags": ["a"]}, {}]
    return pkg.ColumnarEvents(
        event_code=rng.integers(0, len(names), n).astype(np.int32),
        entity_code=rng.integers(0, len(ids), n).astype(np.int32),
        target_code=rng.integers(-1, len(targets), n).astype(np.int32),
        time_us=rng.integers(0, 2 ** 52, n).astype(np.int64),
        tz_min=rng.integers(-720, 720, n).astype(np.int16),
        event_names=names, entity_ids=ids, target_ids=targets,
        properties=[props[j] for j in rng.integers(0, len(props), n)])


def columns_fields(cols) -> list:
    return [np.asarray(getattr(cols, f)).tolist() for f in (
        "event_code", "entity_code", "target_code", "time_us", "tz_min")] + [
        list(cols.event_names), list(cols.entity_ids), list(cols.target_ids),
        list(cols.properties)]


@pytest.mark.parametrize("seed", SEEDS)
def test_ingest_frames_byte_identical_and_cross_decode(seed):
    events = batch(seed)
    blob = port.encode_api_batch(events)
    assert blob == ref.encode_api_batch(events)
    assert port.wire_batch_row_count(blob) == ref.wire_batch_row_count(
        blob) == len(events)
    want = verdicts(ref.decode_api_batch_binary(blob, NOW))
    assert verdicts(port.decode_api_batch_binary(blob, NOW)) == want
    # the JSON route's decode gives the same slots in both packages
    assert verdicts(port.decode_api_batch(events, NOW)) == verdicts(
        ref.decode_api_batch(events, NOW))


@pytest.mark.parametrize("seed", SEEDS)
def test_read_frames_byte_identical_and_cross_decode(seed):
    blob = port.encode_columnar_events(read_columns(port, seed))
    assert blob == ref.encode_columnar_events(read_columns(ref, seed))
    assert columns_fields(port.decode_columnar_events(blob)) == \
        columns_fields(ref.decode_columnar_events(blob))
    parts = [read_columns(port, seed * 10 + j, 8 + j) for j in range(3)]
    ref_parts = [read_columns(ref, seed * 10 + j, 8 + j) for j in range(3)]
    assert columns_fields(port.concat_columnar(parts)) == columns_fields(
        ref.concat_columnar(ref_parts))


def test_frame_direction_and_empty_frames_agree():
    read = port.encode_columnar_events(read_columns(port, 0))
    ingest = port.encode_api_batch(batch(0))
    for blob in (read, ingest, b"", b"PIOC", port.encode_api_batch([])):
        assert outcome(port.decode_api_batch_binary, blob) == outcome(
            ref.decode_api_batch_binary, blob)
        try:
            got = columns_fields(port.decode_columnar_events(blob))
        except Exception as e:  # noqa: BLE001
            got = (type(e).__name__, str(e))
        try:
            want = columns_fields(ref.decode_columnar_events(blob))
        except Exception as e:  # noqa: BLE001
            want = (type(e).__name__, str(e))
        assert got == want


BASES = [ref.encode_api_batch(batch(s, 12)) for s in range(4)]


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(base=st.sampled_from(range(len(BASES))),
       mode=st.sampled_from(["truncate", "flip", "payload"]),
       where=st.floats(0.0, 1.0, exclude_max=True),
       bit=st.integers(0, 7), value=st.integers(0, 255))
def test_fuzzed_frames_fail_or_decode_alike(base, mode, where, bit, value):
    blob = BASES[base]
    if mode == "truncate":
        bad = blob[:int(where * len(blob))]
    elif mode == "flip":
        j = int(where * len(blob))
        bad = blob[:j] + bytes([blob[j] ^ (1 << bit)]) + blob[j + 1:]
    else:
        # a byte of the payload replaced, the CRC32C recomputed: the frame
        # passes the checksum and reaches the structural checks
        payload = bytearray(ref_unframe(blob, magic=ref.WIRE_MAGIC))
        payload[int(where * len(payload))] = value
        bad = ref_frame(bytes(payload), magic=ref.WIRE_MAGIC)
    assert outcome(port.decode_api_batch_binary, bad) == outcome(
        ref.decode_api_batch_binary, bad)
