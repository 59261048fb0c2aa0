"""Out-of-core sharded ingest: an epoch streamed from a manifest of files.

Port of ``analytics_zoo_tpu/data/sharded.py``, with the same semantics:

- **Manifest**: ``ShardSpec(path, kind, size)`` rows probed once at
  construction (``build_manifest``); TFRecord shards decode through
  ``data/tfrecord.py``, ``.npz`` shards through numpy.
- **Per-process assignment**: shard ``i`` belongs to process ``i %
  process_count`` (``assign_shards``), the index and count of the live
  context's job (``parallel.distributed``) when the set is built; each
  process feeds ``batch_size / process_count`` rows of every global
  batch (``_local_bs``) from its own shards.
- **Global shuffle**: an epoch-seeded shard permutation and a record
  shuffle within each window of ``window_shards`` consecutive permuted
  shards, every stream from ``cursor.epoch_rng``, so the same shards,
  seed and window give the JAX package's batches.
- **Cursor**: batch ``k`` of epoch ``e`` starts at record ``k *
  batch_size`` of e's record stream; ``batches(..., start_step=k)`` skips
  the windows before that offset by arithmetic on the manifest's sizes
  and decodes only from the window holding it.
- **Staging**: decoded shards are kept as bytes in a budgeted host store
  (``_StageStore`` over the native sample cache, as in the JAX package),
  so warm epochs replay them without re-parsing the files.

The transfer to the card is what changes.  ``batches`` runs two
background threads: ``zoo-data-decode`` assembles host batches (eager
transforms applied there) and ``zoo-data-stage`` copies each into pinned
host memory and issues a ``non_blocking`` copy to the card on a CUDA
stream of its own, then records an event.  The consumer makes its current
stream wait on that event before it hands the batch on, and marks the
tensors as used on that stream (``record_stream``), so the caching
allocator never reuses their blocks early.  Nothing on the consumer's
thread copies from pageable memory; with ``prefetch <= 0`` (the eager
baseline) the consumer stages each batch itself, through pinned memory.
On the CPU the batches are host tensors.

The spans ``data.decode`` / ``data.stage``, the ``shard_read`` chaos
point (fired before any record leaves a shard) and the ``zoo_data_*``
series are the JAX module's.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common.config import DataConfig
from analytics_zoo_tpu_torch.data.cursor import epoch_rng
from analytics_zoo_tpu_torch.data.featureset import (
    _Batchable, tree_flatten, tree_leaves, tree_map, tree_unflatten)
from analytics_zoo_tpu_torch.parallel import distributed
from analytics_zoo_tpu_torch.testing import chaos

Tree = Any

_m_shards = obs.lazy_counter(
    "zoo_data_shards_read_total",
    "shard reads by the ingest pipeline (decode = parsed from the "
    "source file; stage = replayed from the staging cache)", ["source"])
_m_records = obs.lazy_counter(
    "zoo_data_records_total",
    "records assembled into ingest batches")
_m_depth = obs.lazy_gauge(
    "zoo_data_prefetch_depth",
    "configured depth of the sharded-ingest prefetch pipeline")

# --------------------------------------------------------------- manifest
class ShardSpec:
    """One manifest row: a file shard and its record count."""

    __slots__ = ("path", "kind", "size")

    def __init__(self, path: str, kind: str, size: int):
        if kind not in ("tfrecord", "npz"):
            raise ValueError(f"unknown shard kind {kind!r}")
        self.path = path
        self.kind = kind
        self.size = int(size)

    def __repr__(self):
        return f"ShardSpec({self.path!r}, {self.kind}, {self.size})"


def _shard_kind(path: str) -> str:
    return "npz" if path.endswith(".npz") else "tfrecord"


def _probe_size(path: str, kind: str, verify: bool) -> int:
    if kind == "npz":
        with np.load(path) as z:
            return int(z[z.files[0]].shape[0])
    from analytics_zoo_tpu_torch.data import tfrecord as _tfr
    return sum(1 for _ in _tfr.read_records(path, verify=verify))


def build_manifest(paths: Sequence[str],
                   verify: bool = True) -> List[ShardSpec]:
    """Probe the record counts of shard files (or directories of them).
    The cursor arithmetic and the assignment run on these sizes."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(
                os.path.join(p, n) for n in os.listdir(p)
                if not n.startswith((".", "_"))))
        else:
            files.append(p)
    if not files:
        raise ValueError("empty shard manifest")
    return [ShardSpec(f, _shard_kind(f), _probe_size(f, _shard_kind(f),
                                                     verify))
            for f in files]


def assign_shards(num_shards: int, process_index: int,
                  process_count: int) -> List[int]:
    """The per-process shard assignment: an exact round-robin partition
    of the manifest."""
    if not 0 <= process_index < process_count:
        raise ValueError("process_index out of range")
    return [i for i in range(num_shards)
            if i % process_count == process_index]


# ------------------------------------------------------------- stage store
class _StageStore:
    """Decoded-shard byte store: the native tiered cache
    (``native.NativeSampleCache``: a DRAM budget off the Python heap,
    least recently used shards spilled to disk), as the JAX store uses it.
    A value is the concatenated raw bytes of one shard's leaves.  A host
    library that cannot be built raises with ``g++``'s output."""

    def __init__(self, capacity_bytes: int):
        from analytics_zoo_tpu_torch.native import NativeSampleCache
        self.capacity = int(capacity_bytes)
        self.cache = NativeSampleCache(self.capacity)

    def put(self, sid: int, blob: bytes) -> None:
        self.cache.put(sid, np.frombuffer(blob, np.uint8))

    def get(self, sid: int) -> Optional[bytes]:
        arr = self.cache.get(sid, dtype=np.uint8)
        return None if arr is None else arr.tobytes()

    def remove(self, sid: int) -> None:
        self.cache.remove(sid)

    def close(self) -> None:
        self.cache.close()


# --------------------------------------------------------- the feature set
class ShardedFeatureSet(_Batchable):
    """Out-of-core FeatureSet over a manifest of file shards.

    ``feature_keys`` / ``label_keys`` name the per-record columns (``.npz``
    shards written with the ``f<i>`` / ``l<i>`` convention of
    ``write_npz_shards`` may omit them).  ``transforms`` is a
    ``data.transforms.Transforms`` chain: with ``fuse=True`` the estimator
    runs it inside the step; otherwise it applies in the pipeline."""

    #: the estimator checks this before passing ``start_step`` on resume
    supports_cursor = True

    def __init__(self, shards, feature_keys: Optional[Sequence[str]] = None,
                 label_keys: Optional[Sequence[str]] = None,
                 shuffle: bool = True, seed: int = 0,
                 window_shards: int = 2,
                 transforms=None, prefetch: Optional[int] = None,
                 stage_cache: bool = True,
                 cache_bytes: int = 256 << 20, verify: bool = True):
        if shards and isinstance(shards[0], ShardSpec):
            self.manifest = list(shards)
        else:
            self.manifest = build_manifest(list(shards), verify=verify)
        self.feature_keys = (list(feature_keys)
                             if feature_keys is not None else None)
        self.label_keys = (list(label_keys)
                           if label_keys is not None else None)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.window_shards = max(1, int(window_shards))
        self.transforms = transforms
        self.prefetch = prefetch
        self.verify = verify
        self._stage = (_StageStore(cache_bytes) if stage_cache else None)
        self._n = sum(s.size for s in self.manifest)
        self._process_count = distributed.process_count()
        self._local = assign_shards(len(self.manifest),
                                    distributed.process_index(),
                                    self._process_count)
        self._local_n = sum(self.manifest[i].size for i in self._local)
        # leaf structure (shapes past the leading dim, dtypes, treedefs),
        # recorded from the first decode; identical across shards
        self._spec = None
        self._probe_structure()

    # ---- sizes ------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def size(self) -> int:
        return self._n

    @property
    def labels(self):
        return True if self._spec["n_label_leaves"] else None

    def _local_bs(self, batch_size: int) -> int:
        pc = self._process_count
        if batch_size % pc != 0:
            raise ValueError(
                f"global batch_size {batch_size} must divide by the "
                f"process count {pc}")
        return batch_size // pc

    def steps_per_epoch(self, batch_size: int,
                        drop_remainder: bool = True) -> int:
        lbs = self._local_bs(batch_size)
        if drop_remainder:
            return self._local_n // lbs
        return math.ceil(self._local_n / lbs)

    # ---- decode / staging -------------------------------------------------
    def _probe_structure(self) -> None:
        """Structure facts from the first local shard.  Its arrays stage
        at once (set-up: no chaos point, no metric), so epoch 0 replays
        them instead of decoding that shard twice."""
        si = self._local[0] if self._local else 0
        feats, labels = self._decode(self.manifest[si])
        f_leaves, f_def = tree_flatten(feats)
        l_leaves, l_def = (tree_flatten(labels)
                           if labels is not None else ([], None))
        if self._stage is not None:
            self._stage.put(si, self._leaves_to_blob(f_leaves, l_leaves))
        self._spec = {
            "f_def": f_def, "l_def": l_def,
            "f_shapes": [a.shape[1:] for a in f_leaves],
            "f_dtypes": [a.dtype for a in f_leaves],
            "l_shapes": [a.shape[1:] for a in l_leaves],
            "l_dtypes": [a.dtype for a in l_leaves],
            "n_label_leaves": len(l_leaves),
        }

    def _decode(self, spec: ShardSpec):
        """Parse one shard file into (features, labels) trees."""
        if spec.kind == "npz":
            with np.load(spec.path) as z:
                files = set(z.files)
                if self.feature_keys is not None:
                    feats = {k: z[k] for k in self.feature_keys}
                    if len(self.feature_keys) == 1:
                        feats = feats[self.feature_keys[0]]
                    labels = None
                    if self.label_keys:
                        labels = {k: z[k] for k in self.label_keys}
                        if len(self.label_keys) == 1:
                            labels = labels[self.label_keys[0]]
                else:       # the f<i> / l<i> convention
                    nf = sum(1 for k in files if k.startswith("f"))
                    nl = sum(1 for k in files if k.startswith("l"))
                    fl = [z[f"f{j}"] for j in range(nf)]
                    ll = [z[f"l{j}"] for j in range(nl)]
                    feats = fl[0] if len(fl) == 1 else tuple(fl)
                    labels = (None if not ll
                              else ll[0] if len(ll) == 1 else tuple(ll))
                return feats, labels
        from analytics_zoo_tpu_torch.data import tfrecord as _tfr
        if self.feature_keys is None:
            raise ValueError(
                "tfrecord shards need explicit feature_keys")
        examples = [_tfr.parse_example(r)
                    for r in _tfr.read_records(spec.path,
                                               verify=self.verify)]
        feats = _tfr.examples_to_arrays(examples, self.feature_keys)
        if len(self.feature_keys) == 1:
            feats = feats[self.feature_keys[0]]
        labels = None
        if self.label_keys:
            labels = _tfr.examples_to_arrays(examples, self.label_keys)
            if len(self.label_keys) == 1:
                labels = labels[self.label_keys[0]]
        return feats, labels

    @staticmethod
    def _leaves_to_blob(f_leaves, l_leaves) -> bytes:
        return b"".join(np.ascontiguousarray(a).tobytes()
                        for a in list(f_leaves) + list(l_leaves))

    def _blob_to_leaves(self, blob: bytes, n_records: int):
        sp = self._spec
        off = 0
        out_f, out_l = [], []
        for shapes, dtypes, out in (
                (sp["f_shapes"], sp["f_dtypes"], out_f),
                (sp["l_shapes"], sp["l_dtypes"], out_l)):
            for shape, dt in zip(shapes, dtypes):
                nb = n_records * int(np.prod(shape, dtype=np.int64)
                                     or 1) * dt.itemsize
                arr = np.frombuffer(blob, dtype=dt, count=nb // dt.itemsize,
                                    offset=off)
                out.append(arr.reshape((n_records,) + tuple(shape)))
                off += nb
        return out_f, out_l

    def _read_shard(self, si: int):
        """(feature leaves, label leaves) of shard ``si``: staged bytes
        when held, else a decode of the file (then staged).  The
        ``shard_read`` chaos point fires before any state advances, so an
        injected fault loses no records."""
        chaos.fire("shard_read")
        spec = self.manifest[si]
        if self._stage is not None:
            blob = self._stage.get(si)
            if blob is not None:
                _m_shards.labels(source="stage").inc()
                return self._blob_to_leaves(blob, spec.size)
        feats, labels = self._decode(spec)
        f_leaves = tree_leaves(feats)
        l_leaves = tree_leaves(labels) if labels is not None else []
        _m_shards.labels(source="decode").inc()
        if self._stage is not None:
            self._stage.put(si, self._leaves_to_blob(f_leaves, l_leaves))
        return f_leaves, l_leaves

    def evict(self) -> None:
        """Drop every staged shard (the next epoch decodes from the
        files)."""
        if self._stage is not None:
            for si in range(len(self.manifest)):
                self._stage.remove(si)

    # ---- epoch plan / record stream ---------------------------------------
    def _epoch_windows(self, epoch: int, ordered: bool):
        """[(window index, [shard ids], records)] of this process at
        ``epoch``: the seeded shard permutation cut into windows."""
        order = list(self._local)
        if self.shuffle and not ordered:
            perm = epoch_rng(self.seed, epoch, "shards").permutation(
                len(order))
            order = [order[int(i)] for i in perm]
        out = []
        for w, start in enumerate(range(0, len(order),
                                        self.window_shards)):
            ids = order[start:start + self.window_shards]
            out.append((w, ids, sum(self.manifest[i].size for i in ids)))
        return out

    def _record_chunks(self, epoch: int, ordered: bool,
                       start_record: int):
        """(feature leaves, label leaves) chunks of the epoch's record
        stream from ``start_record`` on; windows before the offset are
        skipped without decoding (sizes come from the manifest)."""
        pos = 0
        for w, ids, n_w in self._epoch_windows(epoch, ordered):
            if start_record >= pos + n_w:
                pos += n_w
                continue
            parts = [self._read_shard(si) for si in ids]
            f_leaves = [np.concatenate([p[0][j] for p in parts])
                        for j in range(len(parts[0][0]))]
            l_leaves = [np.concatenate([p[1][j] for p in parts])
                        for j in range(len(parts[0][1]))]
            if self.shuffle and not ordered:
                perm = epoch_rng(self.seed, epoch, "window",
                                 w).permutation(n_w)
                f_leaves = [a[perm] for a in f_leaves]
                l_leaves = [a[perm] for a in l_leaves]
            off = max(0, start_record - pos)
            if off:
                f_leaves = [a[off:] for a in f_leaves]
                l_leaves = [a[off:] for a in l_leaves]
            yield f_leaves, l_leaves
            pos += n_w

    def _assemble(self, f_leaves, l_leaves):
        sp = self._spec
        x = tree_unflatten(sp["f_def"], f_leaves)
        y = (tree_unflatten(sp["l_def"], l_leaves)
             if sp["n_label_leaves"] else None)
        return x, y

    def _host_batches(self, local_bs: int, epoch: int, ordered: bool,
                      start_step: int, drop_remainder: bool):
        """Fixed-size host batches spanning window edges (records carry
        over; an epoch drops only its ragged tail under
        ``drop_remainder``).  An unfused chain applies here."""
        eager_tf = (self.transforms
                    if (self.transforms is not None
                        and not getattr(self.transforms, "fuse", False))
                    else None)
        pend_f: List[List[np.ndarray]] = []
        pend_l: List[List[np.ndarray]] = []
        have = 0

        def emit(f_parts, l_parts, n):
            f = [np.concatenate([p[j] for p in f_parts])[:n]
                 for j in range(len(f_parts[0]))]
            lp = ([np.concatenate([p[j] for p in l_parts])[:n]
                   for j in range(len(l_parts[0]))]
                  if l_parts and l_parts[0] else [])
            x, y = self._assemble(f, lp)
            if eager_tf is not None:
                x = eager_tf.apply_host(x)
            _m_records.inc(n)
            return x, y

        for f_leaves, l_leaves in self._record_chunks(
                epoch, ordered, start_step * local_bs):
            off = 0
            n_chunk = f_leaves[0].shape[0]
            while off < n_chunk:
                take = min(local_bs - have, n_chunk - off)
                pend_f.append([a[off:off + take] for a in f_leaves])
                pend_l.append([a[off:off + take] for a in l_leaves])
                have += take
                off += take
                if have == local_bs:
                    yield emit(pend_f, pend_l, local_bs)
                    pend_f, pend_l, have = [], [], 0
        if have and not drop_remainder:
            yield emit(pend_f, pend_l, have)

    # ---- the feeding surface ----------------------------------------------
    def local_batches(self, batch_size: int, epoch: int = 0,
                      drop_remainder: bool = True, ordered: bool = False):
        """Synchronous host batches (the evaluate / predict feed)."""
        yield from self._host_batches(self._local_bs(batch_size), epoch,
                                      ordered, 0, drop_remainder)

    def batches(self, batch_size: int, epoch: int = 0,
                drop_remainder: bool = True, device=None,
                start_step: int = 0, ctx=None):
        """``(x, y)`` training batches as torch tensors on ``device``
        through the decode and stage threads.  ``start_step`` is the
        resume cursor: the stream begins at batch ``start_step`` of the
        epoch's order.  ``prefetch`` (else ``ctx.config.data.prefetch``,
        else the config default) bounds each stage's queue; ``<= 0`` reads
        and stages in line, the eager baseline."""
        device = torch.device(device) if device is not None \
            else torch.device("cpu")
        depth = (self.prefetch if self.prefetch is not None
                 else ctx.config.data.prefetch if ctx is not None
                 else DataConfig().prefetch)
        _m_depth.set(float(max(depth, 0)))
        host = _pad_ragged(
            self._host_batches(self._local_bs(batch_size), epoch,
                               not self.shuffle, start_step,
                               drop_remainder), 1)
        if depth <= 0:
            return _inline(host, device)
        return _pipeline(host, device, depth)


def _pad_ragged(host_batches, div: int):
    """Zero-pad a ragged final batch up to the next multiple of ``div``
    (the data axis of the JAX package's mesh; one card gives 1, and a
    ragged batch passes as it is).  Full batches pass untouched."""
    for x, y in host_batches:
        n = tree_leaves(x)[0].shape[0]
        if n % div:
            pad = div - n % div
            padf = lambda a: np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
            x = tree_map(padf, x)
            if y is not None:
                y = tree_map(padf, y)
        yield x, y


def _stage(x, y, device: torch.device, stream=None):
    """One host batch as tensors on ``device``.  On the card each leaf is
    copied into pinned host memory and from there, ``non_blocking``, on
    ``stream`` (the current stream when None); returns ``(x, y, event)``
    with the event recorded after the copies (None on the CPU)."""
    if device.type != "cuda":
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        return tree_map(put, x), (None if y is None else tree_map(put, y)), \
            None
    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)) \
            .pin_memory().to(device, non_blocking=True)
        xd = tree_map(put, x)
        yd = None if y is None else tree_map(put, y)
        done = torch.cuda.Event()
        done.record(stream)
    return xd, yd, done


def _hand_over(xd, yd, done):
    """On the consumer's thread: its current stream waits for the stage
    copies, and the tensors are marked as used there, so the allocator
    keeps their blocks until that stream's work is done."""
    if done is not None:
        cur = torch.cuda.current_stream(done.device)
        cur.wait_event(done)
        for t in tree_leaves((xd, yd)):
            if t is not None:
                t.record_stream(cur)
    return xd, yd


def _inline(host_batches, device: torch.device):
    """The eager baseline: each batch read and staged on the consumer's
    thread (through pinned memory on the card)."""
    for x, y in host_batches:
        yield _hand_over(*_stage(x, y, device))


def _pipeline(host_batches, device: torch.device, depth: int):
    """Two background stages, decode (the host-batch generator) and stage
    (the copy to ``device`` on a stream of its own), each behind a
    bounded queue, so the consumer's step overlaps both the next batch's
    decode and its transfer.

    Closing the returned generator stops both threads and drops their
    buffered batches; a worker fault (the ``shard_read`` /
    ``transform_apply`` chaos points included) re-raises on the consuming
    thread with both threads joined."""
    q_host: "queue.Queue" = queue.Queue(maxsize=depth)
    q_dev: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    errbox: List[BaseException] = []
    parent = obs.current_span()
    stream = (torch.cuda.Stream(device) if device.type == "cuda"
              else None)

    def _put(q, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _get(q):
        while not stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return sentinel

    def decode_worker():
        with obs.span("data.decode", parent=parent):
            try:
                for item in host_batches:
                    if not _put(q_host, item):
                        return
            except BaseException as e:   # re-raised on the consumer
                errbox.append(e)
            finally:
                _put(q_host, sentinel)
                close = getattr(host_batches, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass

    def stage_worker():
        with obs.span("data.stage", parent=parent):
            try:
                while True:
                    item = _get(q_host)
                    if item is sentinel:
                        return
                    if not _put(q_dev, _stage(*item, device, stream)):
                        return
            except BaseException as e:
                errbox.append(e)
            finally:
                _put(q_dev, sentinel)

    t_dec = threading.Thread(target=decode_worker, daemon=True,
                             name="zoo-data-decode")
    t_stg = threading.Thread(target=stage_worker, daemon=True,
                             name="zoo-data-stage")
    t_dec.start()
    t_stg.start()
    try:
        while True:
            item = q_dev.get()
            if item is sentinel:
                if errbox:
                    raise errbox[0]
                return
            yield _hand_over(*item)
    finally:
        stop.set()
        for q in (q_host, q_dev):
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        t_dec.join(timeout=5.0)
        t_stg.join(timeout=5.0)


def write_npz_shards(directory: str, features: Tree,
                     labels: Optional[Tree], num_shards: int,
                     prefix: str = "shard") -> List[str]:
    """Write (features, labels) as ``num_shards`` .npz shards with the
    ``f<i>`` / ``l<i>`` leaf convention (leaves in ``jax.tree_util``'s
    order, so either package reads the other's shards)."""
    os.makedirs(directory, exist_ok=True)
    f_leaves, _ = tree_flatten(features)
    l_leaves, _ = (tree_flatten(labels)
                   if labels is not None else ([], None))
    n = f_leaves[0].shape[0]
    per = math.ceil(n / num_shards)
    paths = []
    for i in range(num_shards):
        sel = np.arange(i * per, min((i + 1) * per, n))
        if sel.size == 0:
            continue
        path = os.path.join(directory, f"{prefix}_{i:04d}.npz")
        payload = {f"f{j}": np.asarray(a)[sel]
                   for j, a in enumerate(f_leaves)}
        payload.update({f"l{j}": np.asarray(a)[sel]
                        for j, a in enumerate(l_leaves)})
        np.savez(path, **payload)
        paths.append(path)
    return paths
