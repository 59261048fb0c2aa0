"""The numerics and the wrapper rules of the flash-attention forward
kernel, on the CPU.

The f32 instance of ``ops/csrc/flash_fwd.cu`` takes both products in
3xTF32: each operand is split into ``hi`` (the value with its low 13
mantissa bits cleared, a TF32 number) and ``lo = x - hi`` (of which a TF32
product reads the top 10 mantissa bits), and each product is
``lo.hi + hi.lo + hi.hi`` accumulated in f32.  Emulated here in plain
PyTorch through the whole attention forward, it meets the f32 tolerance
of 2e-5 against ``_reference_attention``; plain TF32 (``hi.hi`` alone)
does not, which is why the kernel splits.  Then the alignment rule under
which the wrapper hands a view to TMA / ``cp.async`` in place, and the
copy it makes (and counts) otherwise.
"""

import math

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops.attention import _reference_attention

F32_ATOL = 2e-5       # the kernel's f32 tolerance against the plain version


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: what a TF32 product reads."""
    bits = x.contiguous().view(torch.int32) & ~0x1FFF
    return bits.view(torch.float32)


def _matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores take it: 1 pass is plain TF32, 3 passes
    are 3xTF32 (lo.hi + hi.lo + hi.hi, f32 accumulation)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = torch.matmul(a_hi, b_hi)
    if passes == 3:
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        out = torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo) + out
    return out


def _emulated_attention(q, k, v, passes: int) -> torch.Tensor:
    """The kernel's f32 arithmetic: S = Q.K^T, softmax in f32, O = P.V,
    both products through ``_matmul``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _matmul(q, k.transpose(-1, -2), passes) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _matmul(p, v, passes) / p.sum(-1, keepdim=True)


def _inputs(D, seed=0, B=2, H=4, T=512):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, T, D),
                                                 dtype=np.float32))
            for _ in range(3)]


@pytest.mark.parametrize("D", [64, 128])
def test_3xtf32_meets_the_f32_tolerance(D):
    q, k, v = _inputs(D)
    ref = _reference_attention(q, k, v)
    err = (_emulated_attention(q, k, v, passes=3) - ref).abs().max().item()
    assert err <= F32_ATOL, err


@pytest.mark.parametrize("D", [64, 128])
def test_plain_tf32_misses_the_f32_tolerance(D):
    q, k, v = _inputs(D)
    ref = _reference_attention(q, k, v)
    err = (_emulated_attention(q, k, v, passes=1) - ref).abs().max().item()
    assert err > F32_ATOL, err


def test_split_is_exact_to_21_bits():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        10000).astype(np.float32))
    hi = _tf32(x)
    lo = _tf32(x - hi)
    # hi carries 10 mantissa bits, lo the next 10 or 11
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -10).all()
    assert ((x - hi - lo).abs() <= x.abs() * 2.0 ** -20).all()


# --- the alignment rule ---------------------------------------------------

def _aligned(t: torch.Tensor) -> bool:
    return _kernels.tma_aligned(t.shape, t.stride(), t.element_size(),
                                t.data_ptr())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_qkv_head_views_are_aligned(dtype):
    # the views keras/layers/self_attention.py hands the kernel
    B, T, H, D = 2, 128, 12, 64
    qkv = torch.zeros(B, T, 3 * H * D, dtype=dtype)
    for t in qkv.split(H * D, dim=-1):
        assert _aligned(t.view(B, T, H, D).transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contiguous_and_ring_shards_are_aligned(dtype):
    x = torch.zeros(2, 12, 4096, 64, dtype=dtype)
    assert _aligned(x)
    for shard in x.chunk(4, dim=2):          # the ring's sequence shards
        assert _aligned(shard)
    assert _aligned(torch.zeros(2, 3, 1, 32, dtype=dtype))   # Tq = 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_views_are_refused(dtype):
    buf = torch.zeros(2 * 3 * 70 * 64 + 8, dtype=dtype)
    assert not _aligned(buf[1:1 + 2 * 3 * 70 * 64].view(2, 3, 70, 64))
    # a row stride of 68 bf16 / 66 f32 elements is no multiple of 16 bytes
    pad = 68 if dtype == torch.bfloat16 else 66
    rows = torch.zeros(2, 3, 70, pad, dtype=dtype)[..., :64]
    assert not _aligned(rows)
    # a broadcast dimension (stride 0) and a non-unit last stride
    assert not _aligned(torch.zeros(2, 1, 70, 64, dtype=dtype)
                        .expand(2, 3, 70, 64))
    assert not _aligned(torch.zeros(2, 3, 64, 70, dtype=dtype)
                        .transpose(-1, -2))


def test_extent_one_dimensions_ignore_their_stride():
    x = torch.zeros(1, 3, 70, 64)
    assert _kernels.tma_aligned(x.shape, (12345, 70 * 64, 64, 1), 4, 0)
    assert not _kernels.tma_aligned((2, 3, 70, 64), (12345, 70 * 64, 64, 1),
                                    4, 0)


def test_wrapper_copies_and_counts_a_misaligned_view():
    wrapper = _kernels.FlashForward()
    buf = torch.randn(2 * 3 * 70 * 64 + 1, dtype=torch.bfloat16)
    view = buf[1:].view(2, 3, 70, 64)
    got = wrapper._readable(view)
    assert wrapper.copies == 1 and got.data_ptr() != view.data_ptr()
    assert _aligned(got) and torch.equal(got, view)
    aligned = torch.randn(2, 3, 70, 64)
    assert wrapper._readable(aligned) is aligned and wrapper.copies == 1
    _kernels.reset_launches()
    assert all(k.copies == 0 for k in _kernels.KERNELS.values())
