"""ctypes bindings for the host C++ library (``libzoo_native``).

A copy of ``analytics_zoo_tpu/native/__init__.py`` without the PJRT
runner: the tiered sample cache, the micro-batching request queue, the
CRC-32C of TFRecord framing and the host image ops, from
``sample_cache.cpp`` and ``serving_queue.cpp`` beside this file.  Host code
with a C ABI and no device code.

The library is built with ``g++`` the first time it is needed, into the
package's ``_build/`` directory (listed in ``.gitignore``), under a name
that hashes its sources and flags: an edited source is rebuilt and a stale
library is never loaded.  The compiler writes a temporary file that
``os.replace`` moves into place, under a lock file, so processes and
threads that build at once leave one whole library.  A failed build
raises ``RuntimeError`` with the compiler's output.  Nothing is built at
import.  The library is loaded with ``ctypes``' default ``RTLD_LOCAL``,
so its ``zoo_*`` symbols never bind to another copy of the same library
in the process.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("sample_cache.cpp", "serving_queue.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """``_build/libzoo_native-<hash>.so``, the hash over the compiler
    flags and every source."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR,
                        f"libzoo_native-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library if its hashed file is missing; returns its
    path.  One build at a time across processes (an exclusive lock on
    ``_build/libzoo_native.lock``); the output lands whole or not at
    all."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libzoo_native.lock"), "a") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(out):       # built while this one waited
            return out
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", *GXX_FLAGS,
               *[os.path.join(_HERE, s) for s in SOURCES], "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except FileNotFoundError as exc:
            raise RuntimeError(f"native build failed: g++ not found "
                               f"({exc})") from None
        except subprocess.CalledProcessError as exc:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"native build failed: {' '.join(cmd)}\n"
                f"{exc.stderr.decode(errors='replace')}") from None
        os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.zoo_cache_create.restype = ctypes.c_void_p
        lib.zoo_cache_create.argtypes = [ctypes.c_size_t, ctypes.c_char_p]
        lib.zoo_cache_destroy.restype = None
        lib.zoo_cache_destroy.argtypes = [ctypes.c_void_p]
        lib.zoo_cache_put.restype = ctypes.c_int
        lib.zoo_cache_put.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                      ctypes.c_char_p, ctypes.c_size_t]
        lib.zoo_cache_get.restype = ctypes.c_int64
        lib.zoo_cache_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                      ctypes.c_void_p, ctypes.c_size_t]
        lib.zoo_cache_size.restype = ctypes.c_int64
        lib.zoo_cache_size.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.zoo_cache_remove.restype = ctypes.c_int
        lib.zoo_cache_remove.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.zoo_cache_count.restype = ctypes.c_uint64
        lib.zoo_cache_count.argtypes = [ctypes.c_void_p]
        lib.zoo_cache_stats.restype = None
        lib.zoo_cache_stats.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint64)]
        lib.zoo_cache_recount.restype = None
        lib.zoo_cache_recount.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_uint64)]
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.zoo_image_resize_bilinear.restype = None
        lib.zoo_image_resize_bilinear.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            f32p, ctypes.c_int64, ctypes.c_int64]
        lib.zoo_image_crop.restype = None
        lib.zoo_image_crop.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, f32p, ctypes.c_int64,
            ctypes.c_int64]
        lib.zoo_image_normalize.restype = None
        lib.zoo_image_normalize.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            f32p, f32p]
        u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.zoo_queue_create.restype = ctypes.c_void_p
        lib.zoo_queue_create.argtypes = []
        lib.zoo_queue_destroy.restype = None
        lib.zoo_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.zoo_queue_close.restype = None
        lib.zoo_queue_close.argtypes = [ctypes.c_void_p]
        lib.zoo_queue_push.restype = ctypes.c_int
        lib.zoo_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       u8, ctypes.c_size_t]
        lib.zoo_queue_pop_batch.restype = ctypes.c_int64
        lib.zoo_queue_pop_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64)]
        # the partitioned request plane: one partition per fleet replica
        # through one queue handle
        lib.zoo_queue_push_part.restype = ctypes.c_int
        lib.zoo_queue_push_part.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, u8,
            ctypes.c_size_t]
        lib.zoo_queue_pop_batch_part.restype = ctypes.c_int64
        lib.zoo_queue_pop_batch_part.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.zoo_queue_drop_part.restype = ctypes.c_int64
        lib.zoo_queue_drop_part.argtypes = [ctypes.c_void_p,
                                            ctypes.c_uint64]
        lib.zoo_queue_fetch.restype = ctypes.c_int64
        lib.zoo_queue_fetch.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                        u8, ctypes.c_size_t]
        lib.zoo_queue_complete.restype = ctypes.c_int
        lib.zoo_queue_complete.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                           u8, ctypes.c_size_t]
        lib.zoo_queue_wait.restype = ctypes.c_int64
        lib.zoo_queue_wait.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       ctypes.c_int64]
        lib.zoo_queue_take.restype = ctypes.c_int64
        lib.zoo_queue_take.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                       u8, ctypes.c_size_t]
        lib.zoo_queue_stats.restype = None
        lib.zoo_queue_stats.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint64)]
        lib.zoo_crc32c.restype = ctypes.c_uint32
        lib.zoo_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        _lib = lib
        return lib


def crc32c(data: bytes) -> int:
    """CRC-32C by the native slicing-by-8 loop (TFRecord framing)."""
    return load_library().zoo_crc32c(data, len(data))


class NativeSampleCache:
    """Tiered DRAM -> disk sample store: DRAM up to ``capacity_bytes``,
    least recently used entries spilled to files under ``spill_dir`` (a
    private temporary directory, removed on close, when not given)."""

    def __init__(self, capacity_bytes: int, spill_dir: Optional[str] = None):
        self._lib = load_library()
        # spill files are named by sample id only: a shared default
        # directory would collide across instances and processes
        self._own_dir = spill_dir is None
        if spill_dir is None:
            spill_dir = tempfile.mkdtemp(prefix="zoo_cache_")
        os.makedirs(spill_dir, exist_ok=True)
        self._spill_dir = spill_dir
        self._h = self._lib.zoo_cache_create(capacity_bytes,
                                             spill_dir.encode())
        if not self._h:
            raise RuntimeError("cache creation failed")
        # the memory ledger's books of the DRAM tier, reconciled against
        # a native recount taken in the same critical section as the
        # incremental `used` counter
        from analytics_zoo_tpu_torch.observability import memory as zoomem
        self._mem_pool = zoomem.get_ledger().register(
            "sample_cache", self._mem_snapshot,
            reconcile_fn=self._mem_reconcile, owner=self)

    def put(self, sample_id: int, arr: np.ndarray) -> None:
        blob = np.ascontiguousarray(arr).tobytes()
        rc = self._lib.zoo_cache_put(self._h, sample_id, blob, len(blob))
        if rc != 0:
            raise IOError(f"put failed for sample {sample_id}")

    def get(self, sample_id: int, dtype=np.float32,
            shape: Optional[Tuple[int, ...]] = None) -> Optional[np.ndarray]:
        n = self._lib.zoo_cache_size(self._h, sample_id)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        got = self._lib.zoo_cache_get(self._h, sample_id, buf, int(n))
        if got < 0:
            raise IOError(f"get failed for sample {sample_id} ({got})")
        arr = np.frombuffer(buf.raw[:got], dtype=dtype)
        return arr.reshape(shape) if shape else arr

    def remove(self, sample_id: int) -> bool:
        """Drop one entry (DRAM or spilled); True when it existed."""
        return self._lib.zoo_cache_remove(self._h, sample_id) == 0

    def __len__(self) -> int:
        return int(self._lib.zoo_cache_count(self._h))

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 5)()
        self._lib.zoo_cache_stats(self._h, out)
        return {"dram_used": out[0], "capacity": out[1], "hits": out[2],
                "misses": out[3], "spills": out[4]}

    def recount(self) -> dict:
        """The entry map recounted under the native mutex, with the
        incremental book read in the same critical section."""
        out = (ctypes.c_uint64 * 4)()
        self._lib.zoo_cache_recount(self._h, out)
        return {"book_used": int(out[0]), "dram_bytes": int(out[1]),
                "dram_entries": int(out[2]), "spilled_entries": int(out[3])}

    def _mem_snapshot(self) -> dict:
        if not self._h:
            return {"capacity_bytes": 0, "used_bytes": 0,
                    "pinned_bytes": 0, "blocks": 0, "owners": {}}
        st = self.stats()
        used = int(st["dram_used"])
        return {"capacity_bytes": int(st["capacity"]),
                "used_bytes": used,
                "pinned_bytes": 0,      # DRAM entries are always spillable
                "blocks": len(self),
                "owners": {"dram": used} if used else {}}

    def _mem_reconcile(self):
        if not self._h:
            return []
        rc = self.recount()
        if rc["book_used"] != rc["dram_bytes"]:
            return [f"dram books say {rc['book_used']} bytes, entry walk "
                    f"sums {rc['dram_bytes']} bytes "
                    f"({rc['dram_entries']} resident, "
                    f"{rc['spilled_entries']} spilled)"]
        return []

    def close(self) -> None:
        if self._h:
            pool = getattr(self, "_mem_pool", None)
            if pool is not None:
                pool.close()
            self._lib.zoo_cache_destroy(self._h)
            self._h = None
            if self._own_dir:
                shutil.rmtree(self._spill_dir, ignore_errors=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---- host image ops --------------------------------------------------------

def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    lib = load_library()
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.float32)
    lib.zoo_image_resize_bilinear(img, h, w, c, out, out_h, out_w)
    return out


def crop(img: np.ndarray, oy: int, ox: int, out_h: int,
         out_w: int) -> np.ndarray:
    lib = load_library()
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    if oy + out_h > h or ox + out_w > w:
        raise ValueError("crop window out of bounds")
    out = np.empty((out_h, out_w, c), np.float32)
    lib.zoo_image_crop(img, h, w, c, oy, ox, out, out_h, out_w)
    return out


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    lib = load_library()
    img = np.ascontiguousarray(img, np.float32).copy()
    h, w, c = img.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.zoo_image_normalize(img, h, w, c, mean, std)
    return img


class RequestQueue:
    """Dynamic micro-batching queue (C++ core, waits outside the GIL).

    Producers ``push`` payloads and ``wait`` for their completions; one
    consumer ``pop_batch``es coalesced work for a single device execution.
    """

    def __init__(self):
        self._lib = load_library()
        self._h = self._lib.zoo_queue_create()
        if not self._h:
            raise RuntimeError("queue creation failed")

    @staticmethod
    def _as_u8(data: bytes):
        return ctypes.cast(ctypes.create_string_buffer(data, len(data)),
                           ctypes.POINTER(ctypes.c_uint8))

    def push(self, req_id: int, payload: bytes, part: int = 0) -> None:
        rc = self._lib.zoo_queue_push_part(self._h, part, req_id,
                                           self._as_u8(payload),
                                           len(payload))
        if rc != 0:
            raise RuntimeError("queue closed")

    def pop_batch(self, max_batch: int, timeout_ms: int = 50,
                  part: int = 0):
        """-> list[(req_id, payload_bytes)] from one partition; [] on
        timeout; None if closed and drained."""
        ids = (ctypes.c_uint64 * max_batch)()
        sizes = (ctypes.c_int64 * max_batch)()
        n = self._lib.zoo_queue_pop_batch_part(self._h, part, max_batch,
                                               timeout_ms, ids, sizes)
        if n < 0:
            return None
        out = []
        for i in range(int(n)):
            buf = (ctypes.c_uint8 * int(sizes[i]))()
            got = self._lib.zoo_queue_fetch(self._h, ids[i], buf,
                                            int(sizes[i]))
            if got < 0:
                raise RuntimeError(f"fetch failed for request {ids[i]}")
            out.append((int(ids[i]), bytes(bytearray(buf[:got]))))
        return out

    def complete(self, req_id: int, payload: bytes) -> None:
        self._lib.zoo_queue_complete(self._h, req_id,
                                     self._as_u8(payload), len(payload))

    def wait(self, req_id: int, timeout_ms: int = 30000):
        """Block for the completion; -> bytes, or None on timeout."""
        n = self._lib.zoo_queue_wait(self._h, req_id, timeout_ms)
        if n <= 0:
            return None
        buf = (ctypes.c_uint8 * int(n))()
        got = self._lib.zoo_queue_take(self._h, req_id, buf, int(n))
        if got < 0:
            return None
        return bytes(bytearray(buf[:got]))

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 4)()
        self._lib.zoo_queue_stats(self._h, out)
        return {"enqueued": out[0], "completed": out[1],
                "depth": out[2], "max_depth": out[3]}

    def close(self) -> None:
        if self._h:
            self._lib.zoo_queue_close(self._h)

    def destroy(self) -> None:
        if self._h:
            self._lib.zoo_queue_destroy(self._h)
            self._h = None
