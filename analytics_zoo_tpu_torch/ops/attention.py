"""Flash attention: the hand-written CUDA kernels and their plain versions.

Port of ``analytics_zoo_tpu/ops/attention.py``.  ``flash_attention`` keeps
the JAX signature and layout (q, k, v as ``(B, H, T, D)``, padding mask
``(B, Tk)`` with 1 for valid keys) and is differentiable through a
``torch.autograd.Function``.  On CUDA tensors its forward launches the
kernel of ``ops/csrc/flash_fwd.cu`` and its backward the kernel of
``ops/csrc/flash_bwd.cu`` (see ``ops/_kernels.py``), or they raise; on CPU
tensors, or when ``backend="plain"`` is asked for, they run
``_reference_attention`` and ``_reference_attention_bwd``, the plain
PyTorch versions the kernels are held to.  There is no dense-attention
crossover: the JAX package's one was measured on a TPU.

Dropout of the attention probabilities uses the same counter hash over
``(seed, b*H + h, q_pos, k_pos)`` as the JAX package, so a seed gives the
same keep-mask, bit for bit, in the kernel, in the plain version and in
JAX.  The hash is 32-bit unsigned arithmetic; torch has no uint32
arithmetic, so the plain version computes in int64 holding values in
``[0, 2**32)`` and splits each multiply so no product overflows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops import _kernels

_NEG_INF = -1e30

# --- counter-based dropout bits (lowbias32 finaliser) ----------------------
_M32 = 0xFFFFFFFF
_MIX_C1 = 0x7FEB352D
_MIX_C2 = 0x846CA68B
_SEED_C = 0x9E3779B9   # golden-ratio stream split
_Q_C = 0x85EBCA77
_K_C = 0xC2B2AE3D

BACKENDS = (None, "plain", "cuda")


def _u32(x) -> torch.Tensor:
    """Integers -> int64 tensor of their low 32 bits, read unsigned."""
    return torch.as_tensor(x).to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)``, every partial
    product below ``2**49`` so int64 never overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    # values are non-negative, so >> is the logical shift the hash needs
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX_C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX_C2)
    return x ^ (x >> 16)


def _dropout_bits(seed, bh, q_ids, k_ids) -> torch.Tensor:
    """Per-position hash bits as int64 holding the uint32 value (the JAX
    version's int32 bits read unsigned); arguments broadcast."""
    h = _mix32(_mul32(_u32(seed), _SEED_C) ^ _u32(bh))
    return _mix32(h ^ _mul32(_u32(q_ids), _Q_C) ^ _mul32(_u32(k_ids), _K_C))


def _dropout_thresh(rate: float) -> int:
    """Drop threshold in 24-bit uniform space (drop iff u24 < t)."""
    return int(round(rate * (1 << 24)))


def _keep_mask(seed, bh, q_ids, k_ids, thresh: int) -> torch.Tensor:
    """Boolean keep-mask: the one definition the kernel mirrors."""
    return (_dropout_bits(seed, bh, q_ids, k_ids) >> 8) >= thresh


def _hash_keep_mask(seed, shape, dropout_p: float,
                    device=None) -> torch.Tensor:
    """``(B, H, Tq, Tk)`` keep-mask: the mask the kernel generates."""
    B, H, Tq, Tk = shape
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    bh_ids = (ar(B)[:, None] * H + ar(H)[None, :])[..., None, None]
    q_ids = ar(Tq)[None, None, :, None]
    k_ids = ar(Tk)[None, None, None, :]
    return _keep_mask(_u32(seed).to(device), bh_ids, q_ids, k_ids,
                      _dropout_thresh(dropout_p))


def _valid(qk_shape, device, causal, padding_mask) -> torch.Tensor:
    """``(1 or B, 1, Tq, Tk)`` boolean: which keys each query row sees."""
    Tq, Tk = qk_shape
    valid = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        valid = torch.tril(valid, diagonal=Tk - Tq)
    valid = valid[None, None]
    if padding_mask is not None:
        valid = valid & padding_mask.to(torch.bool)[:, None, None, :]
    return valid


def _reference_attention(q, k, v, padding_mask=None, causal=False,
                         sm_scale=None, dropout_p=0.0, dropout_seed=None):
    """Plain PyTorch attention, q/k/v ``(B, H, T, D)``: scores and softmax
    in f32, probabilities cast to v's dtype for the values product with
    f32 accumulation, output in q's dtype.  Rows that see no key give
    zeros, as the kernel does; the JAX reference zeroes only rows emptied
    by the padding mask, so the two differ only for causal rows with no
    key at all (Tq > Tk)."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = _valid(scores.shape[-2:], q.device, causal, padding_mask)
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = probs * valid.any(dim=-1, keepdim=True)
    if dropout_p > 0.0 and dropout_seed is not None:
        keep = _hash_keep_mask(dropout_seed, probs.shape, dropout_p,
                               device=q.device)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_p)),
                            torch.zeros_like(probs))
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _reference_attention_bwd(q, k, v, o, g, padding_mask=None, causal=False,
                             sm_scale=None, dropout_p=0.0, seed=None):
    """Plain PyTorch attention backward: ``(dq, dk, dv)`` of
    ``_reference_attention`` given its output ``o`` and the output's
    gradient ``g``, the math of the JAX package's ``_bwd_kernel_single``
    and ``_blockwise_bwd``: P recomputed in f32 (rows that see no key give
    P = 0), ``delta = rowsum(g * o)``, ``Z = keep ? P/(1-r) : 0``,
    ``dP = keep ? (g v^T)/(1-r) : 0``, ``dv = Z^T g``,
    ``dS = P * (dP - delta) * scale``, ``dq = dS k``, ``dk = dS^T q``, with
    Z and dS cast to the input dtype before their products, f32
    accumulation, and gradients in the input dtype."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    f32, in_dt = torch.float32, q.dtype
    q32, k32, v32, g32 = (t.to(f32) for t in (q, k, v, g))
    scores = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    valid = _valid(scores.shape[-2:], q.device, causal, padding_mask)
    scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1) * valid.any(dim=-1, keepdim=True)
    delta = (g32 * o.to(f32)).sum(-1, keepdim=True)
    dp = torch.matmul(g32, v32.transpose(-1, -2))
    z = p
    if dropout_p > 0.0 and seed is not None:
        keep = _hash_keep_mask(seed, p.shape, dropout_p, device=q.device)
        keep_scale = 1.0 / (1.0 - dropout_p)
        zero = torch.zeros((), dtype=f32, device=q.device)
        z = torch.where(keep, p * keep_scale, zero)
        dp = torch.where(keep, dp * keep_scale, zero)
    rounded = lambda t: t.to(in_dt).to(f32)
    ds = rounded(p * (dp - delta) * scale)
    dv = torch.matmul(rounded(z).transpose(-1, -2), g32)
    dq = torch.matmul(ds, k32)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    return dq.to(in_dt), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Attention with the kernels (``kernel=True``) or the plain versions
    as forward and backward.  Saves q, k, v, o and the mask; the dropout
    seed rides as an int, so the backward replays the forward's
    keep-mask."""

    @staticmethod
    def forward(ctx, q, k, v, padding_mask, causal, sm_scale, dropout_p,
                seed, kernel):
        if kernel:
            o = _kernels.flash_fwd(q, k, v, padding_mask, causal=causal,
                                   sm_scale=sm_scale, **_drop_args(
                                       dropout_p, seed))
        else:
            o = _reference_attention(q, k, v, padding_mask, causal,
                                     sm_scale, dropout_p=dropout_p,
                                     dropout_seed=seed)
        ctx.save_for_backward(q, k, v, o, padding_mask)
        ctx.args = (causal, sm_scale, dropout_p, seed, kernel)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, padding_mask = ctx.saved_tensors
        causal, sm_scale, dropout_p, seed, kernel = ctx.args
        if kernel:
            dq, dk, dv = _kernels.flash_bwd(
                q, k, v, o, g, padding_mask, causal=causal,
                sm_scale=sm_scale, **_drop_args(dropout_p, seed))
        else:
            dq, dk, dv = _reference_attention_bwd(
                q, k, v, o, g, padding_mask, causal, sm_scale, dropout_p,
                seed)
        return dq, dk, dv, None, None, None, None, None, None


def _drop_args(dropout_p: float, seed) -> dict:
    """The kernels' dropout arguments: threshold, survivor scale, seed."""
    if not dropout_p:
        return dict(dropout_thresh=0, keep_scale=1.0, seed=0)
    return dict(dropout_thresh=_dropout_thresh(dropout_p),
                keep_scale=1.0 / (1.0 - dropout_p), seed=int(seed))


def flash_attention(q, k, v, padding_mask=None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    backend: Optional[str] = None):
    """Multi-head attention.

    Args:
      q, k, v: ``(B, H, T, D)`` tensors, f32 or bf16 on the card.
      padding_mask: optional ``(B, Tk)`` 1/0 validity mask.
      causal: end-aligned causal mask (row i sees keys <= i + Tk - Tq).
      sm_scale: softmax scale; default ``1/sqrt(D)``.
      dropout_rate: attention-probability dropout in [0, 1); applied only
        when ``dropout_seed`` (an int) is given, as in the JAX package,
        whose inference path passes no seed.
      backend: None runs the kernels for CUDA tensors and the plain
        versions for CPU tensors; ``"cuda"`` demands the kernels;
        ``"plain"`` runs the plain versions on any device (the kernels'
        reference).

    Differentiable in q, k and v: the backward is ``flash_bwd`` where the
    forward was ``flash_fwd``, and ``_reference_attention_bwd`` where it
    was the plain version.  A CUDA tensor never falls back to the plain
    versions: an unsupported shape or dtype, a failed build or a failed
    launch raises.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if dropout_seed is None:
        dropout_rate = 0.0     # inference: no seed, no dropout
    dev = q.device.type
    kernel = not (backend == "plain" or (backend is None and dev == "cpu"))
    if kernel and dev != "cuda":
        raise ValueError(f"the flash-attention kernel needs CUDA tensors; "
                         f"got {q.device} (backend={backend!r})")
    seed = int(dropout_seed) if dropout_rate else None
    return _FlashAttention.apply(q, k, v, padding_mask, bool(causal),
                                 float(sm_scale), float(dropout_rate), seed,
                                 kernel)
