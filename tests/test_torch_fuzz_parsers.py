"""Fuzz the port's untrusted-input parsers (``srf_tpu_torch.data.
tfrecord`` and ``example_proto``): JAX's seven cases
(``tests/test_fuzz_parsers.py``) on the port's copies.

These parsers consume on-disk bytes (the clean-room analogs of TF's C++
tf.data readers, reference: load_speech_data.py:43-46) and have already
had one real overflow-wrapping bounds bug (BENCH_NOTES r3 review); this
pins the contract: arbitrary garbage, truncations and bit flips must
raise a clean ValueError/EOF-style error or return fewer records —
never hang, crash the process, or allocate unboundedly.
"""

import struct

import numpy as np
import pytest

from srf_tpu_torch.data.example_proto import decode_example, encode_example
from srf_tpu_torch.data.tfrecord import (
    TFRecordWriter, count_records, masked_crc32c, read_records,
)


def _write_tfr(tmp_path, records, name="fuzz.tfr"):
    path = tmp_path / name
    with TFRecordWriter(str(path)) as writer:
        for rec in records:
            writer.write(rec)
    return path


def _valid_example():
    return encode_example({
        "input_speech": np.arange(12, dtype=np.float32),
        "target_label": np.asarray([1, 2, 3], np.int64),
        "input_length": np.asarray([4], np.int64),
        "target_length": np.asarray([3], np.int64),
        "utt_id": [b"utt0"],
    })


def test_random_garbage_files(tmp_path):
    rng = np.random.RandomState(0)
    for trial in range(20):
        path = tmp_path / ("g%d.tfr" % trial)
        path.write_bytes(rng.bytes(int(rng.randint(0, 4096))))
        try:
            got = list(read_records(str(path), verify_crc=True))
            assert len(got) < 10000
        except (ValueError, EOFError, OSError):
            pass


def test_truncations_every_boundary(tmp_path):
    """Every prefix of a valid 2-record file either parses a prefix of the
    records or raises cleanly."""
    path = _write_tfr(tmp_path, [b"a" * 37, b"b" * 11])
    blob = path.read_bytes()
    want = [b"a" * 37, b"b" * 11]
    for cut in range(len(blob)):
        p = tmp_path / "cut.tfr"
        p.write_bytes(blob[:cut])
        try:
            got = list(read_records(str(p), verify_crc=True))
        except (ValueError, EOFError, OSError):
            continue
        assert got == want[: len(got)]


def test_bit_flips_detected_or_contained(tmp_path):
    """With CRC verification on, any single corrupted byte either fails
    validation (ValueError) or leaves the other record intact — silent
    wrong-length reads are the one forbidden outcome."""
    rng = np.random.RandomState(1)
    path = _write_tfr(tmp_path, [b"x" * 29, b"y" * 53])
    blob = bytearray(path.read_bytes())
    for trial in range(64):
        i = int(rng.randint(len(blob)))
        flipped = bytearray(blob)
        flipped[i] ^= 1 << int(rng.randint(8))
        p = tmp_path / "flip.tfr"
        p.write_bytes(bytes(flipped))
        try:
            got = list(read_records(str(p), verify_crc=True))
        except (ValueError, EOFError, OSError):
            continue
        for rec in got:
            assert rec in (b"x" * 29, b"y" * 53)


def test_huge_declared_length_rejected(tmp_path):
    """A framing header declaring a multi-GB record must fail the length
    CRC (or raise), not attempt the allocation."""
    header = struct.pack("<Q", 1 << 40)
    path = tmp_path / "huge.tfr"
    path.write_bytes(
        header + struct.pack("<I", masked_crc32c(header)) + b"\x00" * 64
    )
    with pytest.raises((ValueError, EOFError, OSError, MemoryError)):
        list(read_records(str(path), verify_crc=True))


def test_count_records_on_garbage(tmp_path):
    rng = np.random.RandomState(2)
    path = tmp_path / "count.tfr"
    path.write_bytes(rng.bytes(512))
    try:
        n = count_records([str(path)])
        assert n >= 0
    except (ValueError, EOFError, OSError):
        pass


def test_example_proto_fuzz():
    """decode_example on garbage: clean error or a dict; mutated valid
    payloads never produce out-of-bounds reads (python-level: exceptions
    only)."""
    rng = np.random.RandomState(3)
    for trial in range(50):
        data = rng.bytes(int(rng.randint(0, 200)))
        try:
            out = decode_example(data)
            assert isinstance(out, dict)
        except (ValueError, EOFError, struct.error, OverflowError):
            pass
    valid = bytearray(_valid_example())
    for trial in range(100):
        mutated = bytearray(valid)
        i = int(rng.randint(len(mutated)))
        mutated[i] = int(rng.randint(256))
        try:
            out = decode_example(bytes(mutated))
            assert isinstance(out, dict)
        except (ValueError, EOFError, struct.error, OverflowError):
            pass


def test_roundtrip_still_exact(tmp_path):
    """Sanity: the fuzz helpers' writer/encoder round-trip losslessly."""
    rec = _valid_example()
    path = _write_tfr(tmp_path, [rec])
    (got,) = list(read_records(str(path), verify_crc=True))
    assert got == rec
    ex = decode_example(got)
    np.testing.assert_array_equal(
        ex["input_speech"], np.arange(12, dtype=np.float32)
    )
    np.testing.assert_array_equal(ex["target_label"], [1, 2, 3])
    assert ex["utt_id"] == [b"utt0"]
