"""The port's host library (``srf_tpu_torch/csrc/host/srf_io.cc``, built by
``utils/native.py``) on the CPU: its CRC-32C equals JAX's
(``srf_tpu.data.tfrecord.crc32c``) and the port's Python loop over random
lengths from 0 to ~10 KB, aligned and unaligned, and ``crc32c`` takes the
library; its TFRecord scan gives ``tests/test_native.py``'s three cases;
the build's flags follow the host's SSE4.2."""

import ctypes
import struct

import numpy as np
import pytest

from srf_tpu.data import tfrecord as jax_tfrecord
from srf_tpu_torch.data import tfrecord
from srf_tpu_torch.utils import native


@pytest.fixture(scope="module")
def lib():
    handle = native.load_host_lib()
    assert handle, "the port's host library did not build or load (g++)"
    return handle


# 0-17 cover the tail loop and one 8-byte word; the rest random
LENGTHS = list(range(18)) + list(
    np.random.RandomState(0).randint(18, 10240, size=24))


@pytest.mark.parametrize("length", LENGTHS)
def test_crc32c_equals_jax_and_the_python_loop(lib, length):
    rng = np.random.RandomState(length)
    # an unaligned start too: the slice begins 1-7 bytes into a buffer
    skew = length % 8
    data = rng.randint(0, 256, size=length + skew).astype(np.uint8).tobytes()
    data = data[skew:]
    want = jax_tfrecord.crc32c(data)
    assert lib.srf_crc32c(data, len(data)) == want
    assert tfrecord.crc32c_py(data) == want
    assert tfrecord.crc32c(data) == want
    assert tfrecord.masked_crc32c(data) == jax_tfrecord.masked_crc32c(data)


def test_crc32c_takes_the_library(lib, monkeypatch):
    calls = []
    monkeypatch.setattr(tfrecord, "crc32c_py", lambda data: calls.append(
        data) or 0)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the check value
    assert not calls


def test_crc32c_falls_back_to_python_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "load_host_lib", lambda: False)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283


def _scan(lib, buf):
    offs = (ctypes.c_int64 * 8)()
    lens = (ctypes.c_int64 * 8)()
    n = lib.srf_tfrecord_scan(buf, len(buf), 8, offs, lens)
    return n, list(offs), list(lens)


def test_scan_valid_framing(lib):
    payload = b"hello"
    buf = (struct.pack("<Q", len(payload)) + b"\x00" * 4
           + payload + b"\x00" * 4)
    n, offs, lens = _scan(lib, buf)
    assert n == 1
    assert buf[offs[0]:offs[0] + lens[0]] == payload


def test_scan_rejects_overflowing_length(lib):
    # len = 2^64 - 8 wraps a naive pos + len + 4 <= size check
    buf = struct.pack("<Q", 2**64 - 8) + b"\x00" * 4 + b"xxxx"
    assert _scan(lib, buf)[0] == -1


def test_scan_rejects_truncated_record(lib):
    buf = struct.pack("<Q", 100) + b"\x00" * 4 + b"short"
    assert _scan(lib, buf)[0] == -1


def test_scan_finds_the_writers_records(lib, tmp_path):
    path = str(tmp_path / "x.tfrecord")
    records = [b"", b"a", b"abcdefgh" * 37, bytes(range(256))]
    with tfrecord.TFRecordWriter(path) as writer:
        for record in records:
            writer.write(record)
    buf = open(path, "rb").read()
    n, offs, lens = _scan(lib, buf)
    assert n == len(records)
    assert [buf[o:o + k] for o, k in zip(offs[:n], lens[:n])] == records


def test_the_flags_follow_sse42(monkeypatch):
    with open("/proc/cpuinfo") as info:
        has = "sse4_2" in info.read()
    assert ("-msse4.2" in native.FLAGS) == has
    assert native._has_sse42() == has
