"""Wire codecs: ndarray <-> fast binary frames / Arrow (the client wire).

A copy of ``analytics_zoo_tpu/serving/codec.py`` (the port cannot import
it: every ``analytics_zoo_tpu`` import loads jax), so clients of either
package produce and read the same bytes.  Small all-tensor payloads ride
the compact fast frame (``_encode_fast_bytes`` / ``_decode_fast``);
images, string tensors and large tensors ride Arrow IPC.  ``pyarrow`` is
imported only inside the functions that build or read an Arrow frame, so
the fast wire works where ``pyarrow`` is not installed.

Two surfaces over the same frames:

- ``encode_items_bytes`` / ``decode_items_bytes``: raw frame bytes, no
  base64; fast-frame decode is zero-copy (read-only ``np.frombuffer``
  views into the frame).
- ``encode_items`` / ``decode_items``: the legacy base64-string surface;
  ``decode_items`` / ``decode_output`` take raw ``bytes`` too.
"""

from __future__ import annotations

import base64
from typing import Dict, List, Union

import numpy as np


def _pa():
    import pyarrow  # only the Arrow wire needs it
    return pyarrow


class ImageBytes(bytes):
    """Marker type: undecoded image bytes travelling through the wire.
    The port's engine does not decode images yet and rejects them."""


class StringTensor(list):
    """Marker type: a tensor of strings (``decodeString`` parity)."""


Payload = Union[np.ndarray, ImageBytes, StringTensor]

# ---- compact fast wire (tensor-only payloads) ---------------------------
# Small all-tensor payloads ride a compact self-describing binary frame,
# far cheaper to build than an Arrow IPC stream; images, string tensors
# and large tensors stay on the Arrow wire, and decode_items dispatches
# on the frame magic so both wires coexist on one stream.  Set
# ZOO_SERVING_WIRE=arrow (or pass
# wire="arrow") to force full Arrow-wire parity with the reference
# client (``pyzoo/zoo/serving/client.py:99-270``).
import os as _os
import struct as _struct

_FAST_MAGIC = b"ZWF1"
_FAST_MAX_BYTES = 1 << 20


def _fast_wire_enabled() -> bool:
    return _os.environ.get("ZOO_SERVING_WIRE", "fast") != "arrow"


def reference_wire_forced() -> bool:
    """True when ``ZOO_SERVING_WIRE=arrow`` demands full reference-wire
    parity: Arrow frames AND base64-string transport everywhere."""
    return not _fast_wire_enabled()


def _encode_fast_bytes(items: Dict[str, np.ndarray]) -> bytes:
    parts = [_FAST_MAGIC, _struct.pack("<B", len(items))]
    for name, arr in items.items():
        nb = name.encode()
        # dtype.str carries byte order ('<f4'/'>f4'), unlike dtype.name:
        # the frame ships sender-native payload bytes, and a big-endian
        # sender must be decodable (byteswapped) instead of silently
        # round-tripping corrupt values on a little-endian peer
        dt = arr.dtype.str.encode()
        parts.append(_struct.pack("<BB B", len(nb), len(dt), arr.ndim))
        parts.append(nb)
        parts.append(dt)
        parts.append(_struct.pack(f"<{arr.ndim}I", *arr.shape))
        parts.append(arr.tobytes())
    return b"".join(parts)


def _decode_fast(buf, copy: bool = True) -> Dict[str, np.ndarray]:
    """Decode one fast frame.  ``copy=False`` is the zero-copy binary
    path: arrays are read-only ``np.frombuffer`` VIEWS into ``buf`` (the
    frame buffer stays alive through the array's ``.base``); the legacy
    base64-string path keeps ``copy=True`` so its arrays stay writable
    like the Arrow path's.  Every bound is checked: a truncated or
    malformed frame raises ``ValueError``, never an IndexError or a
    silent short read."""
    view = memoryview(buf)
    total = view.nbytes

    def _need(off, k):
        if off + k > total:
            raise ValueError("truncated fast-wire frame")

    _need(0, 5)
    n = view[4]
    off = 5
    out: Dict[str, np.ndarray] = {}
    for _ in range(n):
        _need(off, 3)
        ln, ld, nd = _struct.unpack_from("<BB B", view, off)
        off += 3
        _need(off, ln + ld + 4 * nd)
        try:
            name = bytes(view[off:off + ln]).decode()
            off += ln
            dtype = np.dtype(bytes(view[off:off + ld]).decode())
            off += ld
        except (UnicodeDecodeError, TypeError) as exc:
            raise ValueError(f"malformed fast-wire frame: {exc}") from None
        shape = _struct.unpack_from(f"<{nd}I", view, off)
        off += 4 * nd
        size = 1
        for d in shape:         # python ints: no silent int64 overflow
            size *= d
        nbytes = size * dtype.itemsize
        _need(off, nbytes)
        arr = np.frombuffer(
            view, dtype, count=size, offset=off).reshape(shape)
        if dtype.byteorder in "<>" and not dtype.isnative:
            # frame from an opposite-endian sender: swap to native so
            # numeric values (not raw bytes) round-trip
            arr = arr.astype(dtype.newbyteorder("="))
        elif copy:
            arr = arr.copy()
        out[name] = arr
        off += nbytes
    if off != total:
        raise ValueError("fast-wire frame carries trailing bytes")
    return out


def _tensor_struct(t: np.ndarray) :
    pa = _pa()
    data = pa.array(t.ravel(), type=pa.from_numpy_dtype(t.dtype))
    shape = pa.array(np.asarray(t.shape, np.int32), type=pa.int32())
    return pa.StructArray.from_arrays(
        [_as_list(data, t.size), _as_list(shape, t.ndim),
         pa.array([t.dtype.name], type=pa.string())],
        ["data", "shape", "dtype"])


def encode_items_bytes(items: Dict[str, Payload],
                       wire: str = "auto") -> bytes:
    """dict of payloads -> RAW frame bytes (fast frame | Arrow stream);
    key order preserved.  The binary data plane's encode: no base64
    anywhere — the in-memory and native brokers carry these frames
    verbatim, and only ``RedisBroker`` base64-wraps them at its parity
    boundary.

    - ndarray -> tensor struct (data/shape/dtype); SMALL all-tensor
      payloads ride the compact fast frame unless ``wire="arrow"`` (or
      ``ZOO_SERVING_WIRE=arrow``) forces reference-wire parity
    - bytes / ImageBytes -> base64-JPEG string column (image wire parity)
    - str -> assumed to already be base64 image content
    - list of str (key containing "string") -> '|'-joined string tensor
    """
    # normalize byte order at the edge: the fast frame ships raw native
    # bytes and pyarrow refuses byte-swapped arrays outright
    items = {k: (v.astype(v.dtype.newbyteorder("="))
                 if isinstance(v, np.ndarray)
                 and not isinstance(v, (ImageBytes, StringTensor))
                 and not v.dtype.isnative else v)
             for k, v in items.items()}
    if (wire != "arrow" and _fast_wire_enabled()
            and len(items) < 256
            and all(isinstance(v, np.ndarray)
                    and not isinstance(v, (ImageBytes, StringTensor))
                    for v in items.values())
            and sum(v.nbytes for v in items.values()) <= _FAST_MAX_BYTES
            and all(len(k.encode()) < 256 and v.ndim < 256
                    for k, v in items.items())):
        return _encode_fast_bytes({k: np.ascontiguousarray(v)
                                   for k, v in items.items()})
    pa = _pa()
    arrays, names = [], []
    for name, v in items.items():
        if isinstance(v, (ImageBytes, bytes, bytearray)):
            arrays.append(pa.array(
                [base64.b64encode(bytes(v)).decode("ascii")],
                type=pa.string()))
        elif isinstance(v, str):
            # decode_items unconditionally b64-decodes string columns, so
            # a non-base64 str would round-trip to garbage or a binascii
            # error at the SERVER — validate at the client edge instead
            try:
                # strip whitespace first: encodebytes/CLI base64 wrap with
                # newlines, and the server's default-mode decode accepts
                # them — the validator must not be stricter than the server
                base64.b64decode("".join(v.split()), validate=True)
            except Exception:
                raise ValueError(
                    f"str payload {name!r} is not valid base64; a bare "
                    "str means 'already-base64 image content' on this "
                    "wire — pass raw image bytes/ImageBytes, or a "
                    "list-of-str/StringTensor for text") from None
            arrays.append(pa.array([v], type=pa.string()))
        elif isinstance(v, StringTensor) or (
                isinstance(v, list) and v
                and any(isinstance(e, str) for e in v)):
            # an EXPLICIT empty StringTensor must stay a string column —
            # np.asarray([]) would silently ship a float64 tensor struct
            if not all(isinstance(e, str) for e in v):
                raise TypeError(
                    f"string tensor {name!r} mixes str and non-str "
                    "elements; string tensors must be all-str")
            # list<string> column: the wire is SELF-describing (decode
            # dispatches on the Arrow type, never on the key name)
            strs = pa.array(list(v), type=pa.string())
            arrays.append(_as_list(strs, len(v)))
        else:
            arrays.append(_tensor_struct(np.asarray(v)))
        names.append(name)
    batch = pa.RecordBatch.from_arrays(arrays, names)
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, batch.schema) as writer:
        writer.write_batch(batch)
    return sink.getvalue().to_pybytes()


def encode_items(items: Dict[str, Payload], wire: str = "auto") -> str:
    """Legacy base64-string surface over ``encode_items_bytes`` —
    reference-client transport parity (the wire the reference's Redis
    protocol carries)."""
    return base64.b64encode(encode_items_bytes(items, wire=wire)) \
        .decode("ascii")


def encode_tensors(tensors: Dict[str, np.ndarray]) -> str:
    """Tensor-only convenience (the original wire surface)."""
    return encode_items({k: np.asarray(v) for k, v in tensors.items()})


def _as_list(arr, n: int) :
    pa = _pa()
    return pa.ListArray.from_arrays(pa.array([0, n], type=pa.int32()), arr)


def decode_items_bytes(buf, copy: bool = False) -> Dict[str, Payload]:
    """Inverse of ``encode_items_bytes`` on a raw frame
    (bytes/bytearray/memoryview).  Fast frames decode ZERO-COPY by
    default: tensors are read-only views into ``buf`` (pass
    ``copy=True`` for writable copies); Arrow frames materialize like
    the legacy path.  Malformed or truncated frames raise ``ValueError``
    so transport edges (the HTTP frontend) can answer 400 instead of
    crashing or wedging a connection."""
    if bytes(buf[:4]) == _FAST_MAGIC:
        return _decode_fast(buf, copy=copy)
    pa = _pa()
    try:
        with pa.ipc.open_stream(pa.py_buffer(buf)) as reader:
            batch = next(iter(reader))
    except (pa.ArrowInvalid, StopIteration) as exc:
        raise ValueError(f"undecodable wire frame: {exc}") from None
    return _decode_arrow_batch(batch)


def decode_items(b64) -> Dict[str, Payload]:
    """Inverse of ``encode_items``: tensors come back with their dtype;
    the dispatch is on the Arrow column type (self-describing wire):
    plain string -> ImageBytes (b64-decoded), list<string> -> StringTensor,
    struct -> tensor.  (The reference dispatches string tensors by
    key-name convention, ``PreProcessing.scala:66-71`` — a convention this
    wire doesn't need.)

    Polymorphic over the two transports: raw ``bytes`` (the binary data
    plane) decode directly; ``str`` is base64-inflated first (legacy
    clients, Redis parity wire)."""
    if isinstance(b64, (bytes, bytearray, memoryview)):
        return decode_items_bytes(b64)
    buf = base64.b64decode(b64)
    if buf[:4] == _FAST_MAGIC:
        return _decode_fast(buf)
    with _pa().ipc.open_stream(buf) as reader:
        batch = next(iter(reader))
    return _decode_arrow_batch(batch)


def _decode_arrow_batch(batch) -> Dict[str, Payload]:
    pa = _pa()
    out: Dict[str, Payload] = {}
    for name, field, col in zip(batch.schema.names, batch.schema,
                                batch.columns):
        if pa.types.is_string(field.type):
            out[name] = ImageBytes(base64.b64decode(col[0].as_py()))
            continue
        if pa.types.is_list(field.type) \
                and pa.types.is_string(field.type.value_type):
            out[name] = StringTensor(col[0].as_py())
            continue
        struct = col[0]
        dtype = np.float32
        try:
            d = struct["dtype"].as_py()
            if d:
                dtype = np.dtype(d)
        except KeyError:
            pass  # dtype-less legacy payload
        data = np.asarray(struct["data"].as_py(), dtype)
        shape = [int(s) for s in struct["shape"].as_py()]
        out[name] = data.reshape(shape)
    return out


def decode_tensors(b64: str) -> Dict[str, np.ndarray]:
    """Tensor-only view of ``decode_items`` (original surface)."""
    return {k: v for k, v in decode_items(b64).items()
            if isinstance(v, np.ndarray)}


def encode_ndarray_output(arr: np.ndarray) -> str:
    """Result encoding for HSET value (ndarray-string, ref
    PostProcessing.scala:41).  Format: ``b64(data)|dtype|d0,d1,...``."""
    arr = np.ascontiguousarray(arr)
    return (base64.b64encode(arr.tobytes()).decode()
            + "|" + arr.dtype.name
            + "|" + ",".join(str(d) for d in arr.shape))


def encode_ndarray_output_bytes(arr: np.ndarray) -> bytes:
    """Binary result frame: the same self-describing item frame carrying
    ONE tensor named ``value`` — zero base64 on the in-memory/native
    result plane (the sink's hot path; ``RedisBroker`` base64-wraps it
    at its boundary like every other bytes value)."""
    return encode_items_bytes({"value": np.ascontiguousarray(arr)})


def decode_ndarray_output(s: str) -> np.ndarray:
    parts = s.split("|")
    if len(parts) == 3:          # blob | dtype | shape
        blob, dtype, shape = parts
    else:                        # legacy: blob | shape (float32)
        blob, shape = parts[0], parts[-1]
        dtype = "float32"
    dims = [int(d) for d in shape.split(",")] if shape else []
    return np.frombuffer(base64.b64decode(blob),
                         np.dtype(dtype)).reshape(dims)


def decode_topn_output(s: str):
    """Parse a topN result string ``"cls:prob;cls:prob"`` (the engine's
    encoding of ``top_n_postprocess``, ref PostProcessing.scala:100-115)."""
    pairs = []
    for item in s.split(";"):
        cls, _, prob = item.partition(":")
        pairs.append((int(cls), float(prob)))
    return pairs


def decode_output(s):
    """Dispatch on the wire format: raw bytes are a binary result frame
    (``encode_ndarray_output_bytes``); string ndarray payloads carry
    ``|`` separators; topN strings are ``cls:prob;...``."""
    if isinstance(s, (bytes, bytearray, memoryview)):
        return decode_items_bytes(s)["value"]
    return decode_ndarray_output(s) if "|" in s else decode_topn_output(s)
