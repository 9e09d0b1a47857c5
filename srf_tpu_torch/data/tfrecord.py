"""TFRecord container I/O without TensorFlow (the port's own copy of
``srf_tpu/data/tfrecord.py``, numpy only).

TFRecord framing (one record):
    uint64  length            (little-endian)
    uint32  masked_crc32c(length bytes)
    bytes   data[length]
    uint32  masked_crc32c(data)

The CRC is CRC-32C (Castagnoli), masked per the TFRecord spec:
    masked = ((crc >> 15) | (crc << 17)) + 0xa282ead8  (mod 2^32)

computed by the host library's ``srf_crc32c`` (``csrc/host/srf_io.cc``,
``utils/native.py``) where it loads, else here by slicing-by-8 over
tables built with numpy (the fallback is logged once). Files written here
are byte-equal to the JAX package's for the same records.
"""

import os
import struct

import numpy as np

from srf_tpu_torch.utils import native

# TFRecord framing structs (the container format's, not the proto codec's)
U64_STRUCT = struct.Struct("<Q")
U32_STRUCT = struct.Struct("<I")

_CRC_POLY = 0x82F63B78  # reversed Castagnoli polynomial


def _make_tables(n_slices=8):
    table = np.zeros((n_slices, 256), dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC_POLY if crc & 1 else 0)
        table[0, i] = crc
    for s in range(1, n_slices):
        for i in range(256):
            crc = int(table[s - 1, i])
            table[s, i] = (crc >> 8) ^ int(table[0, crc & 0xFF])
    return table


_TABLES = _make_tables()
_T = [[int(x) for x in row] for row in _TABLES]

def crc32c(data: bytes) -> int:
    """CRC-32C of ``data``: the host library's where it loads, else
    :func:`crc32c_py`."""
    lib = native.load_host_lib()
    if lib:
        return lib.srf_crc32c(data, len(data))
    return crc32c_py(data)


def crc32c_py(data: bytes) -> int:
    """CRC-32C of ``data`` in Python (slicing-by-8 over numpy-built
    tables): the fallback where the host library does not load."""
    crc = 0xFFFFFFFF
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    n = len(data)
    i = 0
    while n - i >= 8:
        crc ^= data[i] | data[i + 1] << 8 | data[i + 2] << 16 | data[i + 3] << 24
        crc = (
            t7[crc & 0xFF]
            ^ t6[(crc >> 8) & 0xFF]
            ^ t5[(crc >> 16) & 0xFF]
            ^ t4[(crc >> 24) & 0xFF]
            ^ t3[data[i + 4]]
            ^ t2[data[i + 5]]
            ^ t1[data[i + 6]]
            ^ t0[data[i + 7]]
        )
        i += 8
    while i < n:
        crc = (crc >> 8) ^ t0[(crc ^ data[i]) & 0xFF]
        i += 1
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class TFRecordWriter:
    """Write framed records to a file."""

    def __init__(self, path: str):
        self._file = open(path, "wb")

    def write(self, record: bytes) -> None:
        length_bytes = U64_STRUCT.pack(len(record))
        self._file.write(length_bytes)
        self._file.write(U32_STRUCT.pack(masked_crc32c(length_bytes)))
        self._file.write(record)
        self._file.write(U32_STRUCT.pack(masked_crc32c(record)))

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify_crc: bool = False):
    """Yield raw record byte strings from a TFRecord file."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    end = len(data)
    while pos < end:
        if end - pos < 12:
            raise ValueError("truncated TFRecord header in %s" % path)
        (length,) = U64_STRUCT.unpack_from(data, pos)
        if verify_crc:
            (len_crc,) = U32_STRUCT.unpack_from(data, pos + 8)
            if masked_crc32c(data[pos : pos + 8]) != len_crc:
                raise ValueError("bad length crc in %s @%d" % (path, pos))
        pos += 12
        record = data[pos : pos + length]
        if len(record) != length:
            raise ValueError("truncated TFRecord payload in %s" % path)
        pos += length
        if verify_crc:
            if end - pos < 4:
                raise ValueError(
                    "truncated TFRecord crc in %s @%d" % (path, pos)
                )
            (rec_crc,) = U32_STRUCT.unpack_from(data, pos)
            if masked_crc32c(record) != rec_crc:
                raise ValueError("bad record crc in %s @%d" % (path, pos))
        pos += 4
        yield record


def iter_record_spans(path: str, verify_crc: bool = False):
    """Yield ``(payload_offset, payload_length, record_bytes)`` per record.

    The span addresses the record's PAYLOAD bytes inside the file, so a
    later ``read_record_at(path, offset, length)`` returns exactly the
    bytes yielded here — the index a lazy (out-of-core) dataset keeps
    instead of the decoded features (the counterpart of the
    reference's streaming ``tf.data.TFRecordDataset`` reader, reference:
    tfsr/data/load_speech_data.py:43-46)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    end = len(data)
    while pos < end:
        if end - pos < 12:
            raise ValueError("truncated TFRecord header in %s" % path)
        (length,) = U64_STRUCT.unpack_from(data, pos)
        if verify_crc:
            (len_crc,) = U32_STRUCT.unpack_from(data, pos + 8)
            if masked_crc32c(data[pos : pos + 8]) != len_crc:
                raise ValueError("bad length crc in %s @%d" % (path, pos))
        pos += 12
        record = data[pos : pos + length]
        if len(record) != length:
            raise ValueError("truncated TFRecord payload in %s" % path)
        if end - pos - length < 4:
            raise ValueError("truncated TFRecord crc in %s @%d" % (path, pos))
        if verify_crc:
            (rec_crc,) = U32_STRUCT.unpack_from(data, pos + length)
            if masked_crc32c(record) != rec_crc:
                raise ValueError("bad record crc in %s @%d" % (path, pos))
        yield pos, length, record
        pos += length + 4


def read_record_at(fd: int, offset: int, length: int) -> bytes:
    """Positional read of one record payload (thread-safe: ``os.pread``
    never moves a shared file offset, so loader prefetch threads and the
    eval path can share one fd per shard without locking)."""
    data = os.pread(fd, length, offset)
    if len(data) != length:
        raise ValueError("short read at offset %d" % offset)
    return data


def count_records(pattern_or_paths) -> int:
    """Count records across files (glob pattern string or list of paths).

    Replaces the reference's TFRecordDataset iteration count
    (reference: tfsr/helper/data_helper.py:30-48).
    """
    import glob as _glob

    if isinstance(pattern_or_paths, str):
        paths = sorted(_glob.glob(pattern_or_paths))
    else:
        paths = list(pattern_or_paths)
    total = 0
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        end = len(data)
        while pos < end:
            # same framing validation as read_records: an unchecked walk
            # would silently COUNT a truncated/corrupt trailing record
            # that the loader then refuses, desyncing steps-per-epoch
            # from what training actually delivers
            if end - pos < 12:
                raise ValueError(
                    "truncated TFRecord header in %s at offset %d"
                    % (path, pos))
            (length,) = U64_STRUCT.unpack_from(data, pos)
            pos += 12
            if length > end - pos or end - pos - length < 4:
                raise ValueError(
                    "truncated TFRecord payload in %s at offset %d"
                    % (path, pos))
            pos += length + 4
            total += 1
    return total
