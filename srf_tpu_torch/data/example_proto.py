"""Minimal protobuf wire-format codec for ``tf.train.Example`` (the port's
own copy of ``srf_tpu/data/example_proto.py``, numpy only).

Clean-room implementation of just enough of the protobuf wire format to read
and write the Example records the reference framework produces and consumes
(reference: tfsr/data/save_speech_data.py:55-62,178-184 writes features
``target_label`` int64-list, ``input_speech`` float-list, ``input_length``,
``target_length``, ``utt_id`` bytes-list; tfsr/data/load_speech_data.py:52-88
parses them back). No TensorFlow or protobuf dependency.

Schema (from tensorflow/core/example/{example,feature}.proto):
    Example   { Features features = 1; }
    Features  { map<string, Feature> feature = 1; }
    Feature   { oneof kind { BytesList bytes_list = 1;
                             FloatList float_list = 2;
                             Int64List int64_list = 3; } }
    BytesList { repeated bytes value = 1; }
    FloatList { repeated float value = 1 [packed = true]; }
    Int64List { repeated int64 value = 1 [packed = true]; }
"""

import struct

import numpy as np

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def _write_varint(buf: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            buf.append(byte | 0x80)
        else:
            buf.append(byte)
            return


def _read_varint(data: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        if pos >= len(data):  # untrusted input: clean error, never IndexError
            raise ValueError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _tag(field_number: int, wire_type: int) -> int:
    return (field_number << 3) | wire_type


def _write_len_delimited(buf: bytearray, field_number: int, payload: bytes) -> None:
    _write_varint(buf, _tag(field_number, _WT_LEN))
    _write_varint(buf, len(payload))
    buf.extend(payload)


def _encode_feature(value) -> bytes:
    """Encode one Feature from a numpy array / list / bytes list."""
    inner = bytearray()
    if isinstance(value, (bytes, str)):
        value = [value]
    arr = value
    if isinstance(arr, np.ndarray) and arr.dtype.kind == "f":
        payload = np.asarray(arr, dtype="<f4").ravel().tobytes()
        lst = bytearray()
        _write_len_delimited(lst, 1, payload)  # packed floats
        _write_len_delimited(inner, 2, bytes(lst))  # float_list
    elif isinstance(arr, np.ndarray) and arr.dtype.kind in "iu":
        lst = bytearray()
        packed = bytearray()
        for v in arr.ravel().tolist():
            _write_varint(packed, int(v))
        _write_len_delimited(lst, 1, bytes(packed))  # packed varints
        _write_len_delimited(inner, 3, bytes(lst))  # int64_list
    elif len(arr) > 0 and isinstance(arr[0], (bytes, str)):
        lst = bytearray()
        for item in arr:
            if isinstance(item, str):
                item = item.encode("utf-8")
            _write_len_delimited(lst, 1, item)
        _write_len_delimited(inner, 1, bytes(lst))  # bytes_list
    else:
        # generic python number list: infer float vs int via numpy's own
        # dtype inference — isinstance(v, float) is False for np.float32
        # scalars, which an isinstance test would silently TRUNCATE into
        # an Int64List
        inferred = np.asarray(arr)
        if inferred.dtype.kind == "f":
            return _encode_feature(np.asarray(arr, dtype=np.float32))
        if inferred.dtype.kind not in "iu" and len(arr) == 0:
            # an empty list of bytes/str has no element to sniff; treat
            # empty object-kind lists as an empty BytesList so the value
            # keeps its type on roundtrip
            _write_len_delimited(inner, 1, b"")  # empty bytes_list
            return bytes(inner)
        return _encode_feature(np.asarray(arr, dtype=np.int64))
    return bytes(inner)


def encode_example(features: dict) -> bytes:
    """Serialize ``{name: value}`` to a ``tf.train.Example`` byte string.

    Values: float ndarray -> FloatList, int ndarray/list -> Int64List,
    bytes/str (or lists of them) -> BytesList.
    """
    feats_buf = bytearray()
    for name, value in features.items():
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))  # map key
        _write_len_delimited(entry, 2, _encode_feature(value))  # map value
        _write_len_delimited(feats_buf, 1, bytes(entry))  # Features.feature
    out = bytearray()
    _write_len_delimited(out, 1, bytes(feats_buf))  # Example.features
    return bytes(out)


def _skip_field(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == _WT_VARINT:
        _, pos = _read_varint(data, pos)
    elif wire_type == _WT_I64:
        pos += 8
    elif wire_type == _WT_LEN:
        size, pos = _read_varint(data, pos)
        pos += size
    elif wire_type == _WT_I32:
        pos += 4
    else:
        raise ValueError("unsupported wire type %d" % wire_type)
    return pos


def _decode_float_list(data: bytes) -> np.ndarray:
    values = []
    pos = 0
    end = len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if field == 1 and wt == _WT_LEN:  # packed
            size, pos = _read_varint(data, pos)
            values.append(np.frombuffer(data, dtype="<f4", count=size // 4, offset=pos))
            pos += size
        elif field == 1 and wt == _WT_I32:  # unpacked
            values.append(np.frombuffer(data, dtype="<f4", count=1, offset=pos))
            pos += 4
        else:
            pos = _skip_field(data, pos, wt)
    if not values:
        return np.zeros((0,), np.float32)
    return np.concatenate(values) if len(values) > 1 else np.asarray(values[0])


def _decode_int64_list(data: bytes) -> np.ndarray:
    values = []
    pos = 0
    end = len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if field == 1 and wt == _WT_LEN:  # packed
            size, pos = _read_varint(data, pos)
            stop = pos + size
            while pos < stop:
                v, pos = _read_varint(data, pos)
                if v >= 1 << 63:
                    v -= 1 << 64
                values.append(v)
        elif field == 1 and wt == _WT_VARINT:
            v, pos = _read_varint(data, pos)
            if v >= 1 << 63:
                v -= 1 << 64
            values.append(v)
        else:
            pos = _skip_field(data, pos, wt)
    return np.asarray(values, dtype=np.int64)


def _decode_bytes_list(data: bytes):
    values = []
    pos = 0
    end = len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if field == 1 and wt == _WT_LEN:
            size, pos = _read_varint(data, pos)
            values.append(data[pos : pos + size])
            pos += size
        else:
            pos = _skip_field(data, pos, wt)
    return values


def _decode_feature(data: bytes):
    pos = 0
    end = len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if wt != _WT_LEN:
            pos = _skip_field(data, pos, wt)
            continue
        size, pos = _read_varint(data, pos)
        payload = data[pos : pos + size]
        pos += size
        if field == 1:
            return _decode_bytes_list(payload)
        if field == 2:
            return _decode_float_list(payload)
        if field == 3:
            return _decode_int64_list(payload)
    return None


def decode_example(data: bytes) -> dict:
    """Parse a serialized ``tf.train.Example`` into ``{name: value}``."""
    features = {}
    pos = 0
    end = len(data)
    while pos < end:
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if field == 1 and wt == _WT_LEN:  # Example.features
            size, pos = _read_varint(data, pos)
            fend = pos + size
            while pos < fend:
                fkey, pos = _read_varint(data, pos)
                ffield, fwt = fkey >> 3, fkey & 7
                if ffield == 1 and fwt == _WT_LEN:  # Features.feature entry
                    esize, pos = _read_varint(data, pos)
                    eend = pos + esize
                    name = None
                    value = None
                    while pos < eend:
                        ekey, pos = _read_varint(data, pos)
                        efield, ewt = ekey >> 3, ekey & 7
                        if ewt == _WT_LEN:
                            vsize, pos = _read_varint(data, pos)
                            payload = data[pos : pos + vsize]
                            pos += vsize
                            if efield == 1:
                                name = payload.decode("utf-8")
                            elif efield == 2:
                                value = _decode_feature(payload)
                        else:
                            pos = _skip_field(data, pos, ewt)
                    if name is not None:
                        features[name] = value
                else:
                    pos = _skip_field(data, pos, fwt)
        else:
            pos = _skip_field(data, pos, wt)
    return features

