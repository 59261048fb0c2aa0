"""Build and bind the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` exports a plain C function; it is compiled with
``nvcc`` for ``sm_90a`` into a shared library under the package's
``_build/`` directory (listed in ``.gitignore``) the first time it is
needed, and loaded with ``ctypes``.  Libraries are named by a hash of their
source, so an edited kernel is rebuilt and a stale one is never loaded.
Sources build in parallel, one ``nvcc`` each.

Every wrapper checks its tensors before it launches, launches on PyTorch's
current stream, raises if the launch returned a CUDA error, and counts its
launches in ``.launches`` (a plain integer, raised only where the kernel
is launched).  Nothing is built or loaded at import, so a CPU-only install
imports this module too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("flash_fwd.cu", "flash_bwd.cu")
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
#: each library's entry point and its C signature
_ENTRY = {
    "flash_fwd.cu": ("zoo_flash_fwd", [_PTR] * 5 + [_I64] * 12 + [_I32] * 6
                     + [_F32, _I32, _U32, _F32, _I32, _PTR]),
    "flash_bwd.cu": ("zoo_flash_bwd", [_PTR] * 11
                     + [ctypes.POINTER(_I64)] + [_I32] * 6
                     + [_F32, _I32, _U32, _F32, _I32, _PTR]),
}


def _lib(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` with its entry point declared."""
    lib = _load(source)
    name, argtypes = _ENTRY[source]
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


class _Wrapper:
    """A kernel's wrapper: ``launches`` counts the launches that returned
    no error (what a run reads to show a path went through the kernel)."""

    name = ""

    def __init__(self):
        self.launches = 0
        self._count_lock = threading.Lock()

    def _launched(self, lib: ctypes.CDLL, rc: int) -> None:
        if rc != 0:
            raise KernelLaunchError(
                f"{self.name} launch failed: {_cuda_error(lib, rc)}")
        with self._count_lock:
            self.launches += 1


class FlashForward(_Wrapper):
    """Wrapper of ``zoo_flash_fwd`` (``csrc/flash_fwd.cu``): attention
    forward over q ``(B, H, Tq, D)``, k / v ``(B, H, Tk, D)`` CUDA tensors,
    any (batch, head, seq) strides with a unit last stride.  Returns the
    output as a ``(B, H, Tq, D)`` view of a ``(B, Tq, H, D)`` buffer, so
    merging the heads back afterwards is free."""

    name = "flash_fwd"

    def __call__(self, q, k, v, padding_mask=None, causal=False,
                 sm_scale=1.0, dropout_thresh=0, keep_scale=1.0,
                 seed=0) -> torch.Tensor:
        _check(self.name, q, k, v, padding_mask)
        B, H, Tq, D = q.shape
        Tk = k.shape[2]
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                   for t in (q, k, v))
        mask = (None if padding_mask is None
                else (padding_mask != 0).to(torch.int32).contiguous())
        out = torch.empty((B, Tq, H, D), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        lib = _lib("flash_fwd.cu")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            rc = lib.zoo_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *out.stride()[:3], B, H, Tq, Tk, D, _DTYPES[q.dtype],
                float(sm_scale), int(bool(causal)), int(dropout_thresh),
                float(keep_scale), _as_i32(seed), stream)
        self._launched(lib, rc)
        return out


class FlashBackward(_Wrapper):
    """Wrapper of ``zoo_flash_bwd`` (``csrc/flash_bwd.cu``): the gradients
    ``(dq, dk, dv)`` of attention given q, k, v, the forward's output o
    and the output's gradient g, with the forward's mask, causal flag,
    scale and dropout seed.  Same layouts and strides as
    ``FlashForward``; each gradient is returned as a ``(B, H, T, D)`` view
    of a ``(B, T, H, D)`` buffer, so undoing the head split is free.  One
    call launches the kernel's two passes and counts one launch."""

    name = "flash_bwd"

    def __call__(self, q, k, v, o, g, padding_mask=None, causal=False,
                 sm_scale=1.0, dropout_thresh=0, keep_scale=1.0, seed=0):
        _check(self.name, q, k, v, padding_mask)
        for name, t in (("o", o), ("g", g)):
            if (t.shape != q.shape or t.dtype != q.dtype
                    or t.device != q.device):
                raise ValueError(f"{name} must match q: {tuple(q.shape)} "
                                 f"{q.dtype} on {q.device}, got "
                                 f"{tuple(t.shape)} {t.dtype} on {t.device}")
        B, H, Tq, D = q.shape
        Tk = k.shape[2]
        q, k, v, o, g = (t if t.stride(-1) == 1 else t.contiguous()
                         for t in (q, k, v, o, g))
        mask = (None if padding_mask is None
                else (padding_mask != 0).to(torch.int32).contiguous())
        heads = lambda T: torch.empty((B, T, H, D), dtype=q.dtype,
                                      device=q.device).transpose(1, 2)
        dq, dk, dv = heads(Tq), heads(Tk), heads(Tk)
        lse = torch.empty(B * H * Tq, dtype=torch.float32, device=q.device)
        delta = torch.empty_like(lse)
        strides = (ctypes.c_longlong * 24)(*(
            s for t in (q, k, v, o, g, dq, dk, dv) for s in t.stride()[:3]))
        lib = _lib("flash_bwd.cu")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            rc = lib.zoo_flash_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                g.data_ptr(), None if mask is None else mask.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), strides, B, H, Tq, Tk, D,
                _DTYPES[q.dtype], float(sm_scale), int(bool(causal)),
                int(dropout_thresh), float(keep_scale), _as_i32(seed),
                stream)
        self._launched(lib, rc)
        return dq, dk, dv


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
flash_bwd = FlashBackward()

#: every kernel wrapper of the port, by name (what chip_smoke.py resets,
#: reads and reports)
KERNELS = {k.name: k for k in (flash_fwd, flash_bwd)}


def reset_launches() -> None:
    for kernel in KERNELS.values():
        kernel.launches = 0
