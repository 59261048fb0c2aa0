"""TFRecord files without TensorFlow: the framing and ``tf.Example``.

Port of ``analytics_zoo_tpu/data/tfrecord.py``.  A record is framed as
length / masked CRC32C / payload / masked CRC32C, and its payload is a
``tf.Example`` protobuf; both formats are public and stable, so host code
reads and writes them with no TF dependency.  The protobuf wire primitives
are this module's own copy of those in ``analytics_zoo_tpu/onnx/proto.py``
(host-only code, copied because any ``analytics_zoo_tpu`` import loads
jax).  CRC32C is the table loop (the JAX package's fallback; its native
slicing-by-8 library is ROADMAP Queue 1 item 6).  A file the writer here
produces is byte-identical to the JAX writer's from the same examples.
"""

from __future__ import annotations

import os
import struct
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np

__all__ = [
    "read_records", "write_records", "parse_example", "build_example",
    "read_example_file", "examples_to_arrays",
]


# ------------------------------------------------------- protobuf wire format
# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # two's complement, like protobuf int64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _signed(value: int) -> int:
    """varints are unsigned on the wire; int64 fields reinterpret."""
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's fields."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _I64:
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == _LEN:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == _I32:
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def emit_bytes(num: int, value: bytes) -> bytes:
    return _write_varint((num << 3) | _LEN) + _write_varint(len(value)) \
        + value


def _parse_packed_varints(raw: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(raw):
        v, pos = _read_varint(raw, pos)
        out.append(_signed(v))
    return out


# ------------------------------------------------------------------ crc32c
# Castagnoli CRC-32 (poly 0x1EDC6F41, reflected 0x82F63B78), the checksum
# TFRecord framing uses, masked per the Snappy / TFRecord convention.
def _make_table() -> List[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


_MASK_DELTA = 0xA282EAD8


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA & 0xFFFFFFFF


# ----------------------------------------------------------------- framing
def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,), (len_crc,) = (struct.unpack("<Q", header[:8]),
                                     struct.unpack("<I", header[8:]))
            if verify and _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"{path}: corrupt length CRC")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise ValueError(f"{path}: truncated record body")
            if verify and _masked_crc(data) != struct.unpack("<I", footer)[0]:
                raise ValueError(f"{path}: corrupt data CRC")
            yield data


def write_records(path: str, records: Iterable[bytes]) -> int:
    """Write payloads with TFRecord framing; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))
            n += 1
    return n


# -------------------------------------------------------------- tf.Example
# Wire schema (public tensorflow/core/example/{example,feature}.proto):
#   Example  { Features features = 1; }
#   Features { map<string, Feature> feature = 1; }   (map entry: key=1 val=2)
#   Feature  { BytesList bytes_list = 1; FloatList float_list = 2;
#              Int64List int64_list = 3; }
#   *List    { repeated value = 1 }  (float/int64 usually packed)
def _parse_packed_floats(val: bytes, wire: int) -> np.ndarray:
    if wire == _LEN:
        return np.frombuffer(val, dtype="<f4").astype(np.float32)
    # unpacked: iter_fields delivers each fixed32 as its raw 4 bytes
    return np.array([struct.unpack("<f", val)[0]], np.float32)


def _parse_feature(buf: bytes):
    for num, wire, val in iter_fields(buf):
        if num == 1:  # bytes_list
            out = [v for n2, _, v in iter_fields(val) if n2 == 1]
            return out
        if num == 2:  # float_list
            parts = []
            for n2, w2, v in iter_fields(val):
                if n2 == 1:
                    parts.append(_parse_packed_floats(v, w2))
            return (np.concatenate(parts) if parts
                    else np.zeros((0,), np.float32))
        if num == 3:  # int64_list
            vals: List[int] = []
            for n2, w2, v in iter_fields(val):
                if n2 != 1:
                    continue
                if w2 == _VARINT:
                    vals.append(_signed(v))
                else:  # packed
                    vals.extend(_parse_packed_varints(v))
            return np.array(vals, np.int64)
    return np.zeros((0,), np.float32)


def parse_example(record: bytes) -> Dict[str, Union[np.ndarray, List[bytes]]]:
    """Parse one serialized ``tf.Example`` into {name: ndarray | [bytes]}."""
    out: Dict[str, Union[np.ndarray, List[bytes]]] = {}
    for num, _, features_buf in iter_fields(record):
        if num != 1:
            continue
        for fnum, _, entry in iter_fields(features_buf):
            if fnum != 1:
                continue
            key, value = b"", b""
            for enum_, _, v in iter_fields(entry):
                if enum_ == 1:
                    key = v
                elif enum_ == 2:
                    value = v
            out[key.decode("utf-8")] = _parse_feature(value)
    return out


def build_example(features: Dict[str, Union[np.ndarray, Sequence, bytes]]
                  ) -> bytes:
    """Serialize {name: array-like | bytes | [bytes]} as a ``tf.Example``."""
    entries = b""
    for key, value in features.items():
        if isinstance(value, bytes):
            value = [value]
        if (isinstance(value, (list, tuple)) and value
                and isinstance(value[0], bytes)):
            inner = b"".join(emit_bytes(1, b) for b in value)
            feat = emit_bytes(1, inner)
        else:
            arr = np.asarray(value)
            if arr.dtype.kind in "iub":
                packed = b"".join(_write_varint(int(v) & (1 << 64) - 1)
                                  for v in arr.reshape(-1))
                feat = emit_bytes(3, emit_bytes(1, packed))
            else:
                packed = arr.reshape(-1).astype("<f4").tobytes()
                feat = emit_bytes(2, emit_bytes(1, packed))
        entries += emit_bytes(
            1, emit_bytes(1, key.encode("utf-8")) + emit_bytes(2, feat))
    return emit_bytes(1, entries)


# ----------------------------------------------------------- file → arrays
def read_example_file(path: str, verify: bool = True
                      ) -> List[Dict[str, Union[np.ndarray, List[bytes]]]]:
    """All tf.Examples of one shard (or of every shard in a directory)."""
    paths = [path]
    if os.path.isdir(path):
        paths = sorted(p for p in (os.path.join(path, n)
                                   for n in os.listdir(path)
                                   if not n.startswith((".", "_")))
                       if os.path.isfile(p))
    out = []
    for p in paths:
        out.extend(parse_example(r) for r in read_records(p, verify=verify))
    return out


def examples_to_arrays(examples: Sequence[Dict], keys: Optional[
        Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Stack per-example feature dicts into batch-major arrays.

    Fixed-length numeric features stack to ``(N, ...)``; byte features stay
    python lists.  Ragged numeric features raise (pad upstream, like the
    reference's ``shapeSequence`` text verb).
    """
    if not examples:
        return {}
    keys = list(keys) if keys is not None else sorted(examples[0])
    out: Dict[str, np.ndarray] = {}
    for k in keys:
        vals = [ex[k] for ex in examples]
        if isinstance(vals[0], list):   # bytes feature
            out[k] = vals  # type: ignore[assignment]
            continue
        lens = {v.shape for v in vals}
        if len(lens) != 1:
            raise ValueError(
                f"feature {k!r} is ragged across records {sorted(lens)}; "
                "pad to fixed length before batching")
        out[k] = np.stack(vals)
    return out
