"""Flash attention: the hand-written CUDA kernels and their plain versions.

Port of ``analytics_zoo_tpu/ops/attention.py``.  ``flash_attention`` keeps
the JAX signature and layout (q, k, v as ``(B, H, T, D)``, padding mask
``(B, Tk)`` with 1 for valid keys) and is differentiable through a
``torch.autograd.Function``.  On CUDA tensors its forward launches the
kernel of ``ops/csrc/flash_fwd.cu`` and its backward the kernel of
``ops/csrc/flash_bwd.cu`` (see ``ops/_kernels.py``), or they raise; when a
backward will follow, the forward kernel also writes each row's
log-sum-exp, which the backward kernel rebuilds P from; on CPU
tensors, or when ``backend="plain"`` is asked for, they run
``_reference_attention`` and ``_reference_attention_bwd``, the plain
PyTorch versions the kernels are held to.  There is no dense-attention
crossover: the JAX package's one was measured on a TPU.

``flash_forward_with_lse`` is the forward without mask or dropout that
also returns each row's log-sum-exp, the block ring attention merges
shards with (``parallel/ring.py``).  On CUDA tensors it launches the kernel
``flash_fwd_lse`` (``ops/csrc/flash_fwd.cu``) or raises; on CPU tensors it
runs ``_reference_attention_with_lse``.  Like the JAX function it has no
gradient of its own: the ring defines the backward.

Dropout of the attention probabilities uses the same counter hash over
``(seed, b*H + h, q_pos, k_pos)`` as the JAX package, so a seed gives the
same keep-mask, bit for bit, in the kernel, in the plain version and in
JAX.  ``b`` is the row of the global batch: a process that holds rows of
it passes its first row times H as ``bh_offset`` and draws its rows of
the global mask.  The hash is 32-bit unsigned arithmetic; torch has no uint32
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
#: the JAX package's names: "jnp" is the plain version, "pallas" the kernel
#: (which, with no interpret mode here, needs CUDA tensors as "cuda" does)
JAX_BACKENDS = {"jnp": "plain", "pallas": "cuda"}


def resolve_backend(backend: Optional[str]) -> Optional[str]:
    """``backend`` as one of ``BACKENDS``, the JAX names translated;
    ``ValueError`` for anything else."""
    backend = JAX_BACKENDS.get(backend, backend)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS} or "
                         f"{tuple(JAX_BACKENDS)}, got {backend!r}")
    return backend


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


def _hash_keep_mask(seed, shape, dropout_p: float, device=None,
                    bh_offset: int = 0) -> torch.Tensor:
    """``(B, H, Tq, Tk)`` keep-mask: the mask the kernel generates, for
    heads ``bh_offset + b*H + h``."""
    B, H, Tq, Tk = shape
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    bh_ids = (ar(B)[:, None] * H + ar(H)[None, :]
              + int(bh_offset))[..., None, None]
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
                         sm_scale=None, dropout_p=0.0, dropout_seed=None,
                         bh_offset=0):
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
                               device=q.device, bh_offset=bh_offset)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_p)),
                            torch.zeros_like(probs))
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _row_delta(o, g) -> torch.Tensor:
    """``delta = rowsum(g * o)`` in f32, ``(B, H, Tq)``: the plain version
    of ``flash_bwd.cu``'s pre-pass (and the ring's per-shard delta)."""
    return (g.to(torch.float32) * o.to(torch.float32)).sum(-1)


def _reference_attention_bwd(q, k, v, o, g, padding_mask=None, causal=False,
                             sm_scale=None, dropout_p=0.0, seed=None,
                             bh_offset=0):
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
    delta = _row_delta(o, g)[..., None]
    dp = torch.matmul(g32, v32.transpose(-1, -2))
    z = p
    if dropout_p > 0.0 and seed is not None:
        keep = _hash_keep_mask(seed, p.shape, dropout_p, device=q.device,
                               bh_offset=bh_offset)
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
    as forward and backward.  Saves q, k, v, o and the mask, and on the
    kernel path, when a gradient will be asked for, the forward kernel's
    row log-sum-exp (serving under ``inference_mode`` writes none); the
    dropout seed rides along, so the backward replays the forward's
    keep-mask (an int, or a tensor the kernels read on the card).
    ``grad_mode``: whether autograd was recording at the call
    (inside ``forward`` it never is, and ``needs_input_grad`` reads the
    inputs alone)."""

    @staticmethod
    def forward(ctx, q, k, v, padding_mask, causal, sm_scale, dropout_p,
                seed, kernel, grad_mode, bh_offset=0):
        lse = None
        if kernel:
            with_lse = grad_mode and any(ctx.needs_input_grad[:3])
            out = _kernels.flash_fwd(q, k, v, padding_mask, causal=causal,
                                     sm_scale=sm_scale, with_lse=with_lse,
                                     **_drop_args(dropout_p, seed, bh_offset))
            o, lse = out if with_lse else (out, None)
        else:
            o = _reference_attention(q, k, v, padding_mask, causal,
                                     sm_scale, dropout_p=dropout_p,
                                     dropout_seed=seed, bh_offset=bh_offset)
        ctx.save_for_backward(q, k, v, o, padding_mask, lse)
        ctx.args = (causal, sm_scale, dropout_p, seed, bh_offset, kernel)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, padding_mask, lse = ctx.saved_tensors
        causal, sm_scale, dropout_p, seed, bh_offset, kernel = ctx.args
        if kernel:
            dq, dk, dv = _kernels.flash_bwd(
                q, k, v, o, g, lse, padding_mask, causal=causal,
                sm_scale=sm_scale, **_drop_args(dropout_p, seed, bh_offset))
        else:
            dq, dk, dv = _reference_attention_bwd(
                q, k, v, o, g, padding_mask, causal, sm_scale, dropout_p,
                seed, bh_offset)
        return (dq, dk, dv) + (None,) * (len(ctx.needs_input_grad) - 3)


def _drop_args(dropout_p: float, seed, bh_offset: int = 0) -> dict:
    """The kernels' dropout arguments: threshold, survivor scale, seed
    (an int, or a one-integer tensor on the card that the kernel reads)
    and the offset of the first (batch, head) in the hash."""
    if not dropout_p:
        return dict(dropout_thresh=0, keep_scale=1.0, seed=None)
    return dict(dropout_thresh=_dropout_thresh(dropout_p),
                keep_scale=1.0 / (1.0 - dropout_p), seed=seed,
                bh_offset=bh_offset)


def _seed(seed):
    """A dropout seed as the kernels and the plain versions take it: an int
    as a wrapping int32, a one-integer tensor as it is (on the card the
    kernel reads it from device memory, so a CUDA graph's replays each
    read their own)."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.is_floating_point():
            raise ValueError(f"a tensor dropout_seed is one integer, got "
                             f"{tuple(seed.shape)} {seed.dtype}")
        return seed
    return _kernels._as_i32(seed)


def flash_attention(q, k, v, padding_mask=None, causal: bool = False,
                    sm_scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128, backend: Optional[str] = None,
                    dropout_rate: float = 0.0, dropout_rng=None,
                    dropout_seed=None, *, bh_offset: int = 0):
    """Multi-head attention.

    Args:
      q, k, v: ``(B, H, T, D)`` tensors, f32 or bf16 on the card.
      padding_mask: optional ``(B, Tk)`` 1/0 validity mask.
      causal: end-aligned causal mask (row i sees keys <= i + Tk - Tq).
      sm_scale: softmax scale; default ``1/sqrt(D)``.
      block_q, block_k: the TPU kernel's tile sizes, accepted and ignored
        (the CUDA kernel picks its own tiles).
      backend: None runs the kernels for CUDA tensors and the plain
        versions for CPU tensors; ``"cuda"`` (or the JAX package's
        ``"pallas"``) demands the kernels; ``"plain"`` (or ``"jnp"``) runs
        the plain versions on any device (the kernels' reference).
      dropout_rate: attention-probability dropout in [0, 1); applied only
        when ``dropout_seed`` (an int, or a 0-d integer tensor on q's
        device) is given, as in the JAX package, whose inference path
        passes no seed.
      dropout_rng: the JAX package's PRNG key; the port takes the int
        seed as ``dropout_seed`` and raises ``ValueError`` for a key.
      bh_offset: the global ``b*H + h`` of q's first (batch, head) in the
        dropout hash: a process holding rows ``r0..`` of the global batch
        passes ``r0 * H`` and draws its rows of the global keep-mask (0:
        q is the whole batch).

    Differentiable in q, k and v: the backward is ``flash_bwd`` where the
    forward was ``flash_fwd``, and ``_reference_attention_bwd`` where it
    was the plain version.  A CUDA tensor never falls back to the plain
    versions: an unsupported shape or dtype, a failed build or a failed
    launch raises.
    """
    backend = resolve_backend(backend)
    if dropout_rng is not None:
        raise ValueError("dropout_rng (a JAX PRNG key) has no counterpart "
                         "in the port: pass the int seed as dropout_seed")
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
    seed = _seed(dropout_seed) if dropout_rate else None
    return _FlashAttention.apply(q, k, v, padding_mask, bool(causal),
                                 float(sm_scale), float(dropout_rate), seed,
                                 kernel, torch.is_grad_enabled(),
                                 int(bh_offset))


def _reference_attention_with_lse(q, k, v, causal, sm_scale, shift=None):
    """Plain ``(o, lse)`` attention.  ``shift`` generalizes the causal
    offset: q row r attends to k col c iff ``r + shift >= c``; the static
    end-aligned case is ``shift = Tk - Tq`` (the default), and ring
    attention passes a per-block shift (an int or a 0-d tensor).  Scores,
    P and the sums in f32; o in q's dtype, lse ``(B, H, Tq)`` f32 with
    ``-1e30`` for a row that sees no key.  Line for line the JAX
    package's: the ``_NEG_INF/2`` mask threshold and the ``1e-37`` clamp."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        if shift is None:
            shift = Tk - Tq
        r = torch.arange(Tq, device=s.device)[:, None]
        c = torch.arange(Tk, device=s.device)[None, :]
        s = torch.where(r + shift >= c, s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    o = torch.matmul(p, v.float()) / l.clamp_min(1e-37)[..., None]
    lse = torch.where(l > 0.0, m + torch.log(l.clamp_min(1e-37)), _NEG_INF)
    return o.to(q.dtype), lse


def flash_forward_with_lse(q, k, v, causal: bool = False,
                           sm_scale: Optional[float] = None,
                           block_q: int = 128, block_k: int = 128,
                           interpret: Optional[bool] = None,
                           backend: Optional[str] = None):
    """Attention forward that also returns the per-row log-sum-exp:
    ``(o, lse)`` with o ``(B, H, Tq, D)`` in q's dtype and lse ``(B, H,
    Tq)`` f32 (``-1e30`` for a row that sees no key), causal end-aligned.

    ``block_q``, ``block_k`` and ``interpret`` (the TPU kernel's tiles and
    its Pallas interpret mode) are accepted and ignored: the CUDA kernel
    picks its own tiles, and CPU tensors run the plain version.
    ``backend``: None launches the kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``"cuda"`` (``"pallas"``) demands the
    kernel; ``"plain"`` (``"jnp"``) runs ``_reference_attention_with_lse``
    on any device.  A CUDA tensor never falls back: an unsupported shape
    or dtype, a failed build or a failed launch raises.  Any Tq and Tk
    (the TPU kernel's tiling rule, and the fallback it forced, do not
    apply).  No gradient.
    """
    backend = resolve_backend(backend)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dev = q.device.type
    if backend == "plain" or (backend is None and dev == "cpu"):
        return _reference_attention_with_lse(q, k, v, causal, sm_scale)
    if dev != "cuda":
        raise ValueError(f"the flash_fwd_lse kernel needs CUDA tensors; "
                         f"got {q.device} (backend={backend!r})")
    return _kernels.flash_fwd_lse(q, k, v, causal=causal,
                                  sm_scale=sm_scale)


def _shard_seed(seed, di: int, mi: int):
    """The dropout seed of (data, model) block ``(di, mi)``: the JAX
    package's ``_mix32(seed ^ (di * _Q_C) ^ (mi * _K_C))`` in wrapping
    32-bit arithmetic, as an int32 (an int, or a tensor for a tensor
    seed), so a block draws the JAX block's mask over its local indices."""
    mixed = _mix32(_u32(seed) ^ _mul32(_u32(di), _Q_C)
                   ^ _mul32(_u32(mi), _K_C))
    if isinstance(seed, torch.Tensor):
        return (((mixed + (1 << 31)) & _M32) - (1 << 31)).to(
            torch.int32).to(seed.device)
    return _kernels._as_i32(int(mixed))


def sharded_flash_attention(mesh, q, k, v, padding_mask=None,
                            causal: bool = False,
                            sm_scale: Optional[float] = None,
                            dropout_rate: float = 0.0, dropout_seed=None,
                            backend: Optional[str] = None, *,
                            data_axis: str = "data",
                            model_axis: str = "model"):
    """``flash_attention`` over a 2D (data × model) mesh: the batch splits
    over ``data_axis`` and the heads over ``model_axis`` in contiguous
    blocks.  Attention is head-independent, so block ``(di, mi)`` runs the
    ordinary ``flash_attention`` (the kernel on a card) on its
    ``(B/dp, H/mp, T, D)`` slices at the device of mesh coordinate
    ``(di, mi)``, and the outputs are reassembled on q's device.  The
    slices of a fused QKV projection's head views stay views, so the
    kernel reads them in place.

    Requires ``B % dp == 0`` and ``H % mp == 0``.  Dropout: each block's
    seed is re-derived from its coordinates as the JAX package derives it
    (``_shard_seed``), so a block's keep-mask is the JAX block's, bit for
    bit, and differs from the unsharded mask.  Differentiable through each
    block's ``flash_attention``.

    Over several processes q holds this process's rows: ``dp`` counts its
    own data coordinates (``mesh.local_range``), and each block's seed
    takes the block's global data coordinate.
    """
    data_coords = (mesh.local_range(data_axis)
                   if data_axis in mesh.axis_names else range(1))
    dp = len(data_coords)
    mp = mesh.shape.get(model_axis, 1)
    B, H = q.shape[0], q.shape[1]
    if B % max(dp, 1) or H % max(mp, 1):
        raise ValueError(
            f"sharded_flash_attention needs batch % dp == 0 and "
            f"heads % mp == 0: B={B}, H={H}, dp={dp}, mp={mp}")
    has_seed = dropout_rate > 0.0 and dropout_seed is not None
    drop = dropout_rate if has_seed else 0.0
    if has_seed:
        dropout_seed = _seed(dropout_seed)
    bl, hl = B // dp, H // mp
    # the blocks as views from one split a dimension: their backward is
    # one concatenation, where a slice each would zero-fill and add a
    # whole-size gradient per block
    blocks_of = lambda t: [row.split(hl, dim=1) for row in t.split(bl)]
    qs, ks, vs = blocks_of(q), blocks_of(k), blocks_of(v)
    masks = None if padding_mask is None else padding_mask.split(bl)
    rows = []
    for di, dg in enumerate(data_coords):
        blocks = []
        for mi in range(mp):
            coords = {a: i for a, i in ((data_axis, dg), (model_axis, mi))
                      if a in mesh.axis_names}
            dev = mesh.device(coords)
            o = flash_attention(
                qs[di][mi].to(dev), ks[di][mi].to(dev), vs[di][mi].to(dev),
                padding_mask=(None if masks is None
                              else masks[di].to(dev)),
                causal=causal, sm_scale=sm_scale, backend=backend,
                dropout_rate=drop,
                dropout_seed=(_shard_seed(dropout_seed, dg, mi)
                              if has_seed else None))
            blocks.append(o.to(q.device))
        rows.append(torch.cat(blocks, dim=1))
    return torch.cat(rows, dim=0)
