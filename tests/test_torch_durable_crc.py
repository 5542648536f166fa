"""The port's CRC32C without the optional C extension: the lane-parallel
route for large inputs against the JAX package's byte loop, bit for bit
(a checksum has no tolerance)."""

import _torch_cpu  # noqa: F401  (one CPU thread: see the module)
import os

import numpy as np
import pytest

from pio_tpu.utils import durable as ref_durable
from pio_tpu_torch.utils import durable


@pytest.fixture
def table_only(monkeypatch):
    """Both packages on their own table routine."""
    monkeypatch.setattr(durable, "_gcrc32c", None)
    monkeypatch.setattr(ref_durable, "_gcrc32c", None)


def test_check_value(table_only):
    # the CRC-32C check value of the ASCII digits 1..9
    assert durable.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("value", [0, 0xDEADBEEF])
@pytest.mark.parametrize("n", [0, 1, 65_535, 65_536, 65_537, 100_003,
                               262_144 + 17])
def test_lanes_equal_the_byte_loop(table_only, n, value):
    data = np.random.default_rng(n).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    assert durable.crc32c(data, value) == ref_durable.crc32c(data, value)


def test_lanes_continue_a_prior_value(table_only):
    a, b = os.urandom(70_001), os.urandom(90_000)
    assert durable.crc32c(b, durable.crc32c(a)) == durable.crc32c(a + b)
    for kind in (bytearray, memoryview):
        assert durable.crc32c(kind(a + b)) == durable.crc32c(a + b)


def test_frame_round_trip_on_the_lanes(table_only):
    payload = os.urandom(200_000)
    framed = durable.frame(payload)
    assert durable.unframe(framed) == payload
    bad = bytearray(framed)
    bad[-1] ^= 1
    with pytest.raises(durable.ModelIntegrityError):
        durable.unframe(bytes(bad))


def test_lanes_equal_google_crc32c(monkeypatch):
    gcrc = pytest.importorskip("google_crc32c")
    monkeypatch.setattr(durable, "_gcrc32c", None)
    data = os.urandom(3 * (1 << 20) + 5)
    assert durable.crc32c(data) == gcrc.value(data)
    assert durable.crc32c(data, 7) == gcrc.extend(7, data)
