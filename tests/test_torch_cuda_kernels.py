"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips with a reason where no CUDA device is
visible (the kernels have no CPU or interpret mode).  On a machine with
an H100 and nvcc: ``python -m pytest tests/test_torch_cuda_kernels.py``.
Forward tolerances: f32 2e-5 absolute (accumulation order), bf16 2e-2
absolute plus 2**-7 relative (two bf16 ulps of the output).  Backward:
f32 1e-4 * max(1, max|ref|) (summation order through five products),
bf16 2e-2 absolute plus 2**-6 relative (Z and dS are rounded to bf16
before their products, at places the two versions order differently).
"""

import pytest
import torch

from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops.attention import (
    _hash_keep_mask, _reference_attention, _reference_attention_bwd,
    flash_attention)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernel has "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return (2e-5, 0.0) if dtype == torch.float32 else (2e-2, 2.0 ** -7)


def _case(dev, dtype, B, H, Tq, Tk, D, mask=False, seed=0, **kw):
    g = torch.Generator().manual_seed(seed)
    mk = lambda T: torch.randn(B, H, T, D, generator=g).to(dev, dtype)
    q, k, v = mk(Tq), mk(Tk), mk(Tk)
    pm = None
    if mask:
        lens = torch.randint(1, Tk + 1, (B,), generator=g)
        lens[0] = 0                                  # a fully masked row
        pm = (torch.arange(Tk)[None] < lens[:, None]).int().to(dev)
    out = flash_attention(q, k, v, padding_mask=pm, **kw)
    ref = flash_attention(q, k, v, padding_mask=pm, backend="plain", **kw)
    torch.cuda.synchronize()
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(B=4, H=12, Tq=128, Tk=128, D=64, mask=True),
    dict(B=2, H=3, Tq=100, Tk=128, D=64, causal=True),
    dict(B=2, H=3, Tq=77, Tk=50, D=32, causal=True),
    dict(B=3, H=2, Tq=45, Tk=97, D=128, mask=True, causal=True,
         dropout_rate=0.2, dropout_seed=-7),
], ids=["mask", "causal_tq_lt_tk", "causal_tq_gt_tk", "ragged_d128"])
def test_kernel_matches_plain(dev, dtype, case):
    before = _kernels.flash_fwd.launches
    out = _case(dev, dtype, **case)
    assert out.dtype == dtype
    assert _kernels.flash_fwd.launches == before + 1


def test_keep_mask_bit_identical(dev):
    B, H, T, D, p, seed = 2, 3, 128, 64, 0.1, 1234
    q = torch.zeros(B, H, T, D, device=dev)
    keep = torch.empty(B, H, T, T, dtype=torch.bool, device=dev)
    idx = torch.arange(D, device=dev)
    for half in range(T // D):
        v = torch.zeros(B, H, T, D, device=dev)
        v[:, :, half * D + idx, idx] = 1.0       # V row j = one-hot(j)
        o = flash_attention(q, q, v, dropout_rate=p, dropout_seed=seed)
        keep[..., half * D:(half + 1) * D] = o > 0
    assert torch.equal(keep, _hash_keep_mask(seed, (B, H, T, T), p,
                                             device=dev))


def test_strided_head_views_and_bad_head_dim(dev):
    B, T, H, D = 2, 40, 4, 64
    qkv = torch.randn(B, T, 3 * H * D, device=dev)
    q, k, v = (t.view(B, T, H, D).transpose(1, 2)
               for t in qkv.split(H * D, -1))
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention(q, k, v, backend="plain"),
                               atol=2e-5, rtol=0)
    bad = torch.randn(1, 1, 8, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(bad, bad, bad)


def _bwd_case(dev, dtype, B, H, Tq, Tk, D, mask=False, seed=0, **kw):
    """(kernel grads, plain grads, inputs) for one case."""
    g = torch.Generator().manual_seed(seed)
    mk = lambda T: torch.randn(B, H, T, D, generator=g).to(dev, dtype)
    q, k, v, go = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    pm = None
    if mask:
        lens = torch.randint(1, Tk + 1, (B,), generator=g)
        lens[0] = 0                                  # a fully masked row
        pm = (torch.arange(Tk)[None] < lens[:, None]).int().to(dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, padding_mask=pm, **kw)
    got = torch.autograd.grad(o, leaves, go)
    ref = _reference_attention_bwd(
        q, k, v, o.detach(), go, pm, kw.get("causal", False), None,
        kw.get("dropout_rate", 0.0), kw.get("dropout_seed"))
    torch.cuda.synchronize()
    return got, ref, (q, k, v, go, pm)


def _assert_grads_close(got, ref, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape, name
        if dtype == torch.float32:
            atol = 1e-4 * max(1.0, b.abs().max().item())
            torch.testing.assert_close(a, b, atol=atol, rtol=0, msg=name)
        else:
            torch.testing.assert_close(a.float(), b.float(), atol=2e-2,
                                       rtol=2.0 ** -6, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(B=4, H=12, Tq=128, Tk=128, D=64, mask=True),
    dict(B=2, H=3, Tq=100, Tk=128, D=64, causal=True),
    dict(B=2, H=3, Tq=77, Tk=50, D=32, causal=True),
    dict(B=3, H=2, Tq=45, Tk=97, D=128, mask=True, causal=True,
         dropout_rate=0.2, dropout_seed=-7),
    dict(B=4, H=3, Tq=128, Tk=128, D=64, mask=True, dropout_rate=0.1,
         dropout_seed=1234),
    dict(B=2, H=2, Tq=64, Tk=1024, D=64, mask=True),
], ids=["mask", "causal_tq_lt_tk", "causal_tq_gt_tk_d32",
        "dropout_d128", "dropout", "long_k"])
def test_bwd_kernel_matches_plain(dev, dtype, case):
    before = (_kernels.flash_fwd.launches, _kernels.flash_bwd.launches)
    got, ref, _ = _bwd_case(dev, dtype, **case)
    _assert_grads_close(got, ref, dtype)
    assert (_kernels.flash_fwd.launches, _kernels.flash_bwd.launches) == (
        before[0] + 1, before[1] + 1)


def test_bwd_kernel_repeats_bit_identical(dev):
    case = dict(B=4, H=3, Tq=128, Tk=128, D=64, mask=True, dropout_rate=0.1,
                dropout_seed=99)
    first, _, _ = _bwd_case(dev, torch.float32, **case)
    again, _, _ = _bwd_case(dev, torch.float32, **case)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_bwd_kernel_matches_autograd_of_the_plain_forward(dev):
    # an independent derivation: torch autograd through the plain forward
    case = dict(B=2, H=4, Tq=96, Tk=80, D=64, mask=True, causal=True,
                dropout_rate=0.15, dropout_seed=5)
    got, _, (q, k, v, go, pm) = _bwd_case(dev, torch.float32, **case)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = _reference_attention(*leaves, pm, True, None, 0.15, 5)
    want = torch.autograd.grad(o, leaves, go)
    _assert_grads_close(got, want, torch.float32)


def test_bwd_kernel_rows_and_keys_nobody_sees_get_zeros(dev):
    got, _, (_, _, _, _, pm) = _bwd_case(dev, torch.float32, B=3, H=2,
                                         Tq=40, Tk=72, D=32, mask=True)
    dq, dk, dv = got
    assert torch.all(dq[0] == 0)                    # the empty batch row
    dead = (pm == 0)[:, None, :, None].expand_as(dk)
    assert torch.all(dk[dead] == 0) and torch.all(dv[dead] == 0)
