"""Build and bind the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` exports plain C functions (``flash_fwd.cu``
and ``flash_bwd.cu`` two each, one for each of their wrappers); it is
compiled with
``nvcc`` for ``sm_90a`` into a shared library under the package's
``_build/`` directory (listed in ``.gitignore``) the first time it is
needed, and loaded with ``ctypes``.  Libraries are named by a hash of their
source, so an edited kernel is rebuilt and a stale one is never loaded.
Sources build in parallel, one ``nvcc`` each.

Every wrapper checks its tensors before it launches, launches on PyTorch's
current stream, raises if the launch returned a CUDA error, and counts its
launches in ``.launches`` (a plain integer, raised only where the kernel
is launched).  Inside a CUDA graph's capture a call records its launch
instead of running it; ``recording`` and ``replayed`` move that count to
the graph's replays, where the kernels run.  Nothing is built or loaded
at import, so a CPU-only install imports this module too.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import operator
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "paged_decode.cu",
           "paged_chunk.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            DEFAULT_NVCC, shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME); the port's "
                           "CUDA kernels are built from source at first use")


def _lib_path(source: str) -> str:
    """``_build/<name>-<hash>.so``, the hash over the source, every shared
    header of ``csrc/`` and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{source[:-3]}-{h.hexdigest()[:12]}.so")


def build(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc``
    processes started together; returns ``{source: library path}``.
    Raises ``KernelBuildError`` with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {s: _lib_path(s) for s in sources}
    procs = {}
    for src, out in paths.items():
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT), tmp)
    errors = []
    for src, (proc, tmp) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"{src}:\n{log}")
            continue
        with open(paths[src] + ".log", "w") as fh:
            fh.write(log)
        os.replace(tmp, paths[src])   # atomic: readers never see half a file
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    return paths


def _load(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build([source])[source])
            _libs[source] = lib
        return lib


_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_F32, _U32 = ctypes.c_float, ctypes.c_uint
#: each entry point: its library's source and its C signature
_ENTRY = {
    "zoo_flash_fwd": ("flash_fwd.cu", [_PTR] * 6 + [_I64] * 12 + [_I32] * 6
                      + [_F32, _I32, _U32, _F32, _PTR, _U32, _PTR]),
    "zoo_flash_fwd_lse": ("flash_fwd.cu", [_PTR] * 5 + [_I64] * 12
                          + [_I32] * 6 + [_F32, _I32, _PTR]),
    "zoo_flash_bwd": ("flash_bwd.cu", [_PTR] * 12
                      + [ctypes.POINTER(_I64)] + [_I32] * 6
                      + [_F32, _I32, _U32, _F32, _PTR, _U32, _PTR]),
    "zoo_flash_bwd_lse": ("flash_bwd.cu", [_PTR] * 10
                          + [ctypes.POINTER(_I64)] + [_I32] * 6
                          + [_F32, _I32, _PTR]),
    "zoo_paged_decode": ("paged_decode.cu", [_PTR] * 8 + [_I64] * 11
                         + [_I32] * 10 + [_F32, _PTR]),
    "zoo_paged_chunk": ("paged_chunk.cu", [_PTR] * 7 + [_I64] * 10
                        + [_I32] * 10 + [_F32, _PTR]),
}


def _lib(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` with its entry points declared."""
    lib = _load(source)
    for name, (src, argtypes) in _ENTRY.items():
        if src != source:
            continue
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def _check(kernel: str, q, k, v, padding_mask) -> None:
    """Raise ValueError for anything the attention kernels do not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} takes CUDA tensors; {name} is "
                             f"on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, T, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k, v must share dtype and device")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{kernel} takes float32 or bfloat16, got "
                         f"{q.dtype}")
    B, H, Tq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{kernel} has no instance for head dim {D}; "
                         f"supported: {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} "
                         f"does not match q {tuple(q.shape)}")
    if padding_mask is not None and (
            padding_mask.shape != (B, k.shape[2])
            or padding_mask.device != q.device):
        raise ValueError(f"padding_mask must be (B, Tk) = "
                         f"{(B, k.shape[2])} on {q.device}, got "
                         f"{tuple(padding_mask.shape)} on "
                         f"{padding_mask.device}")


def tma_aligned(shape, strides, element_size: int, data_ptr: int) -> bool:
    """Whether a ``(B, H, T, D)`` view can be read by TMA and 16-byte
    ``cp.async`` as it lies: unit last stride, a 16-byte aligned base, and
    every other stride of a dimension longer than 1 a positive multiple of
    16 bytes (a dimension of extent 1 is never stepped over)."""
    if strides[-1] != 1 or data_ptr % 16:
        return False
    return all(n == 1 or (s > 0 and s * element_size % 16 == 0)
               for n, s in zip(shape[:-1], strides[:-1]))


class _Wrapper:
    """A kernel's wrapper: ``launches`` counts the launches that returned
    no error (what a run reads to show a path went through the kernel);
    ``copies`` counts the inputs it had to copy before a launch because
    the kernel cannot read them in place."""

    name = ""

    def __init__(self):
        self.launches = 0
        self.copies = 0
        self._count_lock = threading.Lock()

    def _readable(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` itself when ``tma_aligned``, else a packed copy of it,
        counted in ``copies``."""
        if tma_aligned(t.shape, t.stride(), t.element_size(), t.data_ptr()):
            return t
        with self._count_lock:
            self.copies += 1
        return t.clone(memory_format=torch.contiguous_format)

    def _launched(self, lib: ctypes.CDLL, rc: int) -> None:
        if rc != 0:
            raise KernelLaunchError(
                f"{self.name} launch failed: {_cuda_error(lib, rc)}")
        with self._count_lock:
            self.launches += 1


def _ptr(t):
    """A tensor's address, or a null pointer for None."""
    return None if t is None else t.data_ptr()


def _device_seed(seed, dropout_thresh, device):
    """The dropout seed as the kernels read it: one int32 in device memory
    (None without dropout).  A tensor seed (a 0-d or one-element integer
    tensor on ``device``, what the training step derives on the card) is
    passed as it is, so a captured CUDA graph reads each replay's value;
    an int is written into a new one-element tensor by a fill kernel (no
    host copy, so this also works while a graph is captured)."""
    if not dropout_thresh:
        return None
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.device != device \
                or seed.is_floating_point():
            raise ValueError(f"a tensor dropout seed is one integer on "
                             f"{device}, got {tuple(seed.shape)} "
                             f"{seed.dtype} on {seed.device}")
        return seed.reshape(1).to(torch.int32)
    return torch.full((1,), _as_i32(seed), dtype=torch.int32, device=device)


def _bh_offset(bh_offset) -> int:
    """The hash's (batch, head) offset as the kernels take it: the low 32
    bits, as the hash reads every index."""
    return operator.index(bh_offset) & 0xFFFFFFFF


def _int_mask(padding_mask):
    """The kernels' padding mask: contiguous int32, nonzero = valid."""
    if padding_mask is None or (padding_mask.dtype == torch.int32
                                and padding_mask.is_contiguous()):
        return padding_mask
    return (padding_mask != 0).to(torch.int32).contiguous()


class FlashForward(_Wrapper):
    """Wrapper of ``zoo_flash_fwd`` (``csrc/flash_fwd.cu``): attention
    forward over q ``(B, H, Tq, D)``, k / v ``(B, H, Tk, D)`` CUDA tensors,
    read in place where ``tma_aligned`` (so the head views of a fused QKV
    projection), else copied first and counted in ``copies``.  Returns the
    output as a ``(B, H, Tq, D)`` view of a ``(B, Tq, H, D)`` buffer, so
    merging the heads back afterwards is free; with ``with_lse`` also each
    row's log-sum-exp of the scaled scores before dropout, a contiguous
    ``(B, H, Tq)`` f32 tensor (``-1e30`` for a row that sees no key), which
    ``FlashBackward`` takes.  ``bh_offset`` is added to each head's
    ``b*H + h`` in the dropout hash: the global index of the first
    (batch, head) when ``q`` holds rows of a larger batch."""

    name = "flash_fwd"

    def __call__(self, q, k, v, padding_mask=None, causal=False,
                 sm_scale=1.0, dropout_thresh=0, keep_scale=1.0,
                 seed=0, with_lse=False, bh_offset=0):
        _check(self.name, q, k, v, padding_mask)
        B, H, Tq, D = q.shape
        Tk = k.shape[2]
        q, k, v = (self._readable(t) for t in (q, k, v))
        mask = _int_mask(padding_mask)
        seed = _device_seed(seed, dropout_thresh, q.device)
        out = torch.empty((B, Tq, H, D), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
               if with_lse else None)
        lib = _lib("flash_fwd.cu")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            rc = lib.zoo_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
                out.data_ptr(), _ptr(lse),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], B, H, Tq, Tk, D, _DTYPES[q.dtype],
                float(sm_scale), int(bool(causal)), int(dropout_thresh),
                float(keep_scale), _ptr(seed), _bh_offset(bh_offset), stream)
        self._launched(lib, rc)
        return (out, lse) if with_lse else out


class FlashForwardLse(_Wrapper):
    """Wrapper of ``zoo_flash_fwd_lse`` (``csrc/flash_fwd.cu``): attention
    forward with no mask and no dropout over q ``(B, H, Tq, D)``, k / v
    ``(B, H, Tk, D)`` CUDA tensors (read in place where ``tma_aligned``,
    else copied and counted, as ``FlashForward``), end-aligned when
    ``causal``.  Returns ``(o, lse)``:
    o a contiguous ``(B, H, Tq, D)`` tensor in q's dtype, lse a contiguous
    ``(B, H, Tq)`` f32 tensor of each row's log-sum-exp of the scaled
    scores (``-1e30`` for a row that sees no key)."""

    name = "flash_fwd_lse"

    def __call__(self, q, k, v, causal=False, sm_scale=1.0):
        _check(self.name, q, k, v, None)
        B, H, Tq, D = q.shape
        Tk = k.shape[2]
        q, k, v = (self._readable(t) for t in (q, k, v))
        out = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
        lib = _lib("flash_fwd.cu")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            rc = lib.zoo_flash_fwd_lse(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], *out.stride()[:3], B, H, Tq, Tk, D,
                _DTYPES[q.dtype], float(sm_scale), int(bool(causal)),
                stream)
        self._launched(lib, rc)
        return out, lse


def _check_like(name, t, shape, dtype, device) -> None:
    if t.shape != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")


def _check_rows(name, t, shape, device) -> None:
    """lse / delta: f32 ``(B, H, Tq)`` rows of unit stride."""
    _check_like(name, t, shape, torch.float32, device)
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride along its rows, got "
                         f"{t.stride()}")


def _turns(q):
    """The f32 backward's scratch of per-(batch*head, query tile)
    counters that order the dq sums (its kernel zeroes them)."""
    if q.dtype != torch.float32:
        return None
    B, H, Tq, _ = q.shape
    return torch.empty(B * H * Tq, dtype=torch.int32, device=q.device)


class FlashBackward(_Wrapper):
    """Wrapper of ``zoo_flash_bwd`` (``csrc/flash_bwd.cu``): the gradients
    ``(dq, dk, dv)`` of attention given q, k, v, the forward's output o, the
    forward's row log-sum-exp lse (``FlashForward(with_lse=True)``), the
    output's gradient g, and the forward's mask, causal flag, scale and
    dropout seed.  q, k, v, o and g are read in place where
    ``tma_aligned``, else copied and counted, as ``FlashForward``; each
    gradient is returned as a ``(B, H, T, D)`` view of a ``(B, T, H, D)``
    buffer, so undoing the head split is free.  One call launches the
    delta pre-pass and the kernel (in f32 after zeroing the counters that
    order its dq sums), and counts one launch.  ``bh_offset``: the
    forward's."""

    name = "flash_bwd"

    def __call__(self, q, k, v, o, g, lse, padding_mask=None, causal=False,
                 sm_scale=1.0, dropout_thresh=0, keep_scale=1.0, seed=0,
                 bh_offset=0):
        _check(self.name, q, k, v, padding_mask)
        for name, t in (("o", o), ("g", g)):
            _check_like(name, t, q.shape, q.dtype, q.device)
        B, H, Tq, D = q.shape
        Tk = k.shape[2]
        _check_like("lse", lse, (B, H, Tq), torch.float32, q.device)
        lse = lse.contiguous()
        q, k, v, o, g = (self._readable(t) for t in (q, k, v, o, g))
        mask = _int_mask(padding_mask)
        seed = _device_seed(seed, dropout_thresh, q.device)
        heads = lambda T: torch.empty((B, T, H, D), dtype=q.dtype,
                                      device=q.device).transpose(1, 2)
        dq, dk, dv = heads(Tq), heads(Tk), heads(Tk)
        delta = torch.empty(B * H * Tq, dtype=torch.float32, device=q.device)
        turns = _turns(q)
        strides = (ctypes.c_longlong * 24)(*(
            s for t in (q, k, v, o, g, dq, dk, dv) for s in t.stride()[:3]))
        lib = _lib("flash_bwd.cu")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            rc = lib.zoo_flash_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                g.data_ptr(), _ptr(mask), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), _ptr(turns), strides, B, H,
                Tq, Tk, D, _DTYPES[q.dtype], float(sm_scale),
                int(bool(causal)), int(dropout_thresh), float(keep_scale),
                _ptr(seed), _bh_offset(bh_offset), stream)
        self._launched(lib, rc)
        return dq, dk, dv


class FlashBackwardLse(_Wrapper):
    """Wrapper of ``zoo_flash_bwd_lse`` (``csrc/flash_bwd.cu``): one block
    of ring attention's backward, no mask and no dropout, end-aligned when
    ``causal``.  q, g ``(B, H, Tq, D)`` and k, v ``(B, H, Tk, D)`` CUDA
    tensors of one dtype (read in place where ``tma_aligned``, else copied
    and counted); lse and delta the ring's f32 ``(B, H, Tq)`` row
    statistics; dq ``(B, H, Tq, D)`` and dk, dv ``(B, H, Tk, D)`` f32
    accumulators (unit last stride, even strides), which the block's
    gradients are added into in place.  Returns nothing."""

    name = "flash_bwd_lse"

    def __call__(self, q, k, v, g, lse, delta, dq, dk, dv, causal=False,
                 sm_scale=1.0) -> None:
        _check(self.name, q, k, v, None)
        _check_like("g", g, q.shape, q.dtype, q.device)
        B, H, Tq, D = q.shape
        Tk = k.shape[2]
        for name, t in (("lse", lse), ("delta", delta)):
            _check_rows(name, t, (B, H, Tq), q.device)
        for name, t, shape in (("dq", dq, q.shape), ("dk", dk, k.shape),
                               ("dv", dv, k.shape)):
            _check_like(name, t, shape, torch.float32, q.device)
            if t.stride(-1) != 1 or any(s % 2 for s in t.stride()[:3]) \
                    or t.data_ptr() % 8:
                raise ValueError(f"{name} is added into in place with 8-byte "
                                 f"stores: it needs unit last stride and "
                                 f"even strides, got {t.stride()}")
        q, k, v, g = (self._readable(t) for t in (q, k, v, g))
        turns = _turns(q)
        strides = (ctypes.c_longlong * 25)(
            *(s for t in (q, k, v, g, dq, dk, dv) for s in t.stride()[:3]),
            *lse.stride()[:2], *delta.stride()[:2])
        lib = _lib("flash_bwd.cu")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            rc = lib.zoo_flash_bwd_lse(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _ptr(turns), strides, B, H, Tq,
                Tk, D, _DTYPES[q.dtype], float(sm_scale), int(bool(causal)),
                stream)
        self._launched(lib, rc)


def _check_pages(kernel: str, q, k_pages, v_pages, tables, q_dims: str):
    """Raise ValueError for anything the paged kernels do not take; q is
    ``(N, H, D)`` (``q_dims`` names N), the pools ``(P, bs, Hkv, D)``."""
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("the page table", tables)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{kernel} takes CUDA tensors on one device; "
                             f"{name} is on {t.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be ({q_dims}, H, D), got {tuple(q.shape)}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"k_pages / v_pages must be one (P, bs, Hkv, D) "
                         f"shape, got {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"{kernel} takes float32 or bfloat16 q and pages of "
                         f"one dtype, got {q.dtype} / {k_pages.dtype} / "
                         f"{v_pages.dtype}")
    H, D = q.shape[1:]
    Hkv = k_pages.shape[2]
    if D not in HEAD_DIMS or k_pages.shape[3] != D:
        raise ValueError(f"{kernel} has no instance for head dim {D} "
                         f"(pages {k_pages.shape[3]}); supported: "
                         f"{HEAD_DIMS}")
    if H % Hkv:
        raise ValueError(f"GQA needs H % Hkv == 0, got {H} % {Hkv}")
    if tables.dtype != torch.int32:
        raise ValueError(f"{kernel} takes int32 page tables, got "
                         f"{tables.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("the page table", tables)):
        if t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{name} needs unit stride in its last "
                             f"dimension, got {t.stride()}")


#: the decode kernel's split rule: about this many blocks an SM, and no
#: split shorter than this many keys (one 16-key chunk a warp, several
#: loads in flight)
DECODE_BLOCKS_PER_SM = 8
DECODE_MIN_SPLIT_KEYS = 128
#: the chunk kernel's query rows and keys a block / tile
CHUNK_BLOCK_M = 64
CHUNK_BLOCK_N = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def decode_splits(B: int, Hkv: int, nb: int, bs: int,
                  n_sms: int) -> tuple:
    """``(splits, pages_per_split)`` of ``paged_decode.cu``: each of the
    ``B * Hkv`` (sequence, KV head) pairs is cut into ``splits`` blocks of
    ``pages_per_split`` whole table entries (``splits * pages_per_split >=
    nb``, the last split may be shorter), enough blocks for about
    ``DECODE_BLOCKS_PER_SM`` an SM but none shorter than
    ``DECODE_MIN_SPLIT_KEYS`` keys.  It reads only the table width ``nb *
    bs``: a split that starts at or past a sequence's length reads
    nothing, so the host never needs the lengths."""
    if nb <= 0:
        return 1, 1
    min_pages = _cdiv(DECODE_MIN_SPLIT_KEYS, bs)
    want = _cdiv(DECODE_BLOCKS_PER_SM * n_sms, max(1, B * Hkv))
    splits = max(1, min(want, _cdiv(nb, min_pages)))
    pages = max(min_pages, _cdiv(nb, splits)) if splits > 1 else nb
    return _cdiv(nb, pages), pages


def chunk_splits(H: int, Tc: int, start: int, nb: int, bs: int,
                 n_sms: int) -> int:
    """How many blocks ``paged_chunk.cu`` cuts each 64-row block's key
    tiles over: 1 when the ``H * ceil(Tc / 64)`` row blocks fill the SMs
    twice, else enough to, but no more than the 64-key tiles of the row
    block that sees the fewest keys (the first), so that none of its
    splits is empty."""
    blocks = H * _cdiv(Tc, CHUNK_BLOCK_M)
    if blocks >= 2 * n_sms:
        return 1
    first = min(nb * bs, start + min(CHUNK_BLOCK_M, Tc))
    return max(1, min(_cdiv(2 * n_sms, blocks), _cdiv(first, CHUNK_BLOCK_N)))


_sm_counts: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The device's number of SMs (cached; what the split rules read)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = _sm_counts.get(idx)
    if n is None:
        n = torch.cuda.get_device_properties(idx).multi_processor_count
        _sm_counts[idx] = n
    return n


class PagedDecode(_Wrapper):
    """Wrapper of ``zoo_paged_decode`` (``csrc/paged_decode.cu``): one
    decode step of attention through block tables.  q ``(B, H, D)``, the
    page pools ``(P, bs, Hkv, D)``, ``lengths (B,)`` and ``block_tables
    (B, nb)`` int32, all CUDA tensors; returns ``(B, H, D)`` in q's
    dtype.  Page ids must lie in ``[0, P)`` (the kernel clamps others, as
    JAX's gather does).  The pools are read in place where
    ``tma_aligned`` (the 16-byte copies' rule), else copied and counted.
    The keys are split over blocks by ``decode_splits``; with more than
    one split the call allocates the f32 scratch the splits merge
    through and runs the merging kernel too, and counts one launch.
    ``rule_heads`` is the KV-head count that rule reads (default Hkv): a
    model-parallel shard passes the whole model's, so its keys split as
    the unsharded call's do and each head sums in the same order."""

    name = "paged_decode"

    def __call__(self, q, k_pages, v_pages, lengths, block_tables,
                 sm_scale=1.0, rule_heads=None) -> torch.Tensor:
        _check_pages(self.name, q, k_pages, v_pages, block_tables, "B")
        B, H, D = q.shape
        P, bs, Hkv, _ = k_pages.shape
        if (lengths.shape != (B,) or lengths.dtype != torch.int32
                or lengths.device != q.device):
            raise ValueError(f"lengths must be ({B},) int32 on {q.device}, "
                             f"got {tuple(lengths.shape)} {lengths.dtype} "
                             f"on {lengths.device}")
        if block_tables.dim() != 2 or block_tables.shape[0] != B:
            raise ValueError(f"block_tables must be ({B}, nb), got "
                             f"{tuple(block_tables.shape)}")
        lengths = lengths.contiguous()
        k_pages, v_pages = self._readable(k_pages), self._readable(v_pages)
        nb = block_tables.shape[1]
        splits, pages = decode_splits(B, rule_heads or Hkv, nb, bs,
                                      sm_count(q.device))
        out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
        part_o = part_lse = None
        if splits > 1:
            part_o = torch.empty(B * H * splits * D, dtype=torch.float32,
                                 device=q.device)
            part_lse = torch.empty(B * H * splits, dtype=torch.float32,
                                   device=q.device)
        lib = _lib("paged_decode.cu")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            rc = lib.zoo_paged_decode(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                lengths.data_ptr(), block_tables.data_ptr(), out.data_ptr(),
                _ptr(part_o), _ptr(part_lse),
                *q.stride()[:2], *k_pages.stride()[:3],
                *v_pages.stride()[:3], *out.stride()[:2],
                block_tables.stride(0), B, H, Hkv, D, P, bs, nb, splits,
                pages, _DTYPES[q.dtype], float(sm_scale), stream)
        self._launched(lib, rc)
        return out


class PagedChunk(_Wrapper):
    """Wrapper of ``zoo_paged_chunk`` (``csrc/paged_chunk.cu``): causal
    attention of one prompt chunk through its page table.  q ``(Tc, H,
    D)`` for positions ``start .. start + Tc - 1``, the page pools ``(P,
    bs, Hkv, D)`` already holding the chunk's own K/V, ``page_table
    (nb,)`` int32, all CUDA tensors, and ``start`` a host int; returns
    ``(Tc, H, D)`` in q's dtype.  The pools (and a bf16 q) are read in
    place where ``tma_aligned``, else copied and counted.  Each 64-row
    block's keys are split over ``chunk_splits`` blocks; with more than
    one the call allocates the f32 scratch they merge through and runs
    the merging kernel too, and counts one launch.  ``rule_heads`` is the
    query-head count that rule reads (default H), as for
    ``PagedDecode``."""

    name = "paged_chunk"

    def __call__(self, q, k_pages, v_pages, page_table, start: int,
                 sm_scale=1.0, rule_heads=None) -> torch.Tensor:
        _check_pages(self.name, q, k_pages, v_pages, page_table, "Tc")
        if page_table.dim() != 1:
            raise ValueError(f"page_table must be (nb,), got "
                             f"{tuple(page_table.shape)}")
        start = int(start)
        if start < 0:
            raise ValueError(f"start must be >= 0, got {start}")
        Tc, H, D = q.shape
        P, bs, Hkv, _ = k_pages.shape
        nb = page_table.shape[0]
        k_pages, v_pages = self._readable(k_pages), self._readable(v_pages)
        if q.dtype == torch.bfloat16:       # copied into shared memory too
            q = self._readable(q)
        splits = chunk_splits(rule_heads or H, Tc, start, nb, bs,
                              sm_count(q.device))
        out = torch.empty((Tc, H, D), dtype=q.dtype, device=q.device)
        part_o = part_lse = None
        if splits > 1:
            part_o = torch.empty(splits * H * Tc * D, dtype=torch.float32,
                                 device=q.device)
            part_lse = torch.empty(splits * H * Tc, dtype=torch.float32,
                                   device=q.device)
        lib = _lib("paged_chunk.cu")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            rc = lib.zoo_paged_chunk(
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), out.data_ptr(), _ptr(part_o),
                _ptr(part_lse), *q.stride()[:2], *k_pages.stride()[:3],
                *v_pages.stride()[:3], *out.stride()[:2], Tc, H, Hkv, D, P,
                bs, nb, start, splits, _DTYPES[q.dtype], float(sm_scale),
                stream)
        self._launched(lib, rc)
        return out


def _as_i32(seed: int) -> int:
    """Any integer seed -> the int32 with the same low 32 bits."""
    s = int(seed) & 0xFFFFFFFF
    return s - (1 << 32) if s >= 1 << 31 else s


def _cuda_error(lib: ctypes.CDLL, rc: int) -> str:
    if rc == -1:
        return "no kernel instance for these arguments"
    fn = lib.zoo_cuda_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return f"cudaError {rc} ({fn(rc).decode()})"


flash_fwd = FlashForward()
flash_fwd_lse = FlashForwardLse()
flash_bwd = FlashBackward()
flash_bwd_lse = FlashBackwardLse()
paged_decode = PagedDecode()
paged_chunk = PagedChunk()

#: every kernel wrapper of the port, by name (what chip_smoke.py resets,
#: reads and reports)
KERNELS = {k.name: k for k in (flash_fwd, flash_fwd_lse, flash_bwd,
                               flash_bwd_lse, paged_decode, paged_chunk)}


def reset_launches() -> None:
    """Every wrapper's ``launches`` and ``copies`` back to 0."""
    for kernel in KERNELS.values():
        kernel.launches = 0
        kernel.copies = 0


def _counts() -> Dict[str, tuple]:
    return {k: (w.launches, w.copies) for k, w in KERNELS.items()}


@contextlib.contextmanager
def recording(record: Optional[Dict[str, tuple]] = None):
    """Calls made inside launch nothing that counts: a CUDA graph's
    capture (which records its launches instead of running them) and the
    discarded warm-up step before it.  ``launches`` and ``copies`` are
    restored on exit; when ``record`` is given it receives what the calls
    inside would have counted, ``{name: (launches, copies)}``, which
    ``replayed`` adds once for every replay of the captured graph."""
    before = _counts()
    try:
        yield record
    finally:
        after = _counts()
        for name, kernel in KERNELS.items():
            kernel.launches, kernel.copies = before[name]
            if record is not None:
                record[name] = tuple(a - b for a, b in zip(after[name],
                                                           before[name]))


def replayed(record: Dict[str, tuple], n: int = 1) -> None:
    """Count ``n`` replays of a CUDA graph whose capture ``recording``
    recorded: each replay launches every kernel the capture recorded."""
    for name, (launches, copies) in record.items():
        kernel = KERNELS[name]
        with kernel._count_lock:
            kernel.launches += launches * n
            kernel.copies += copies * n
