"""The flash-attention backward's rules, on the CPU.

``ops/csrc/flash_bwd.cu`` has no CPU mode; its card tests are in
``tests/test_torch_cuda_kernels.py``.  Here, on the same numpy inputs:

- the ring block's plain version (``parallel/ring.py::_block_grads``, the
  reference ``flash_bwd_lse`` is held to on the card) equals ``jax.vjp``
  of the JAX package's ``_reference_attention`` on a full and on a
  diagonal block, to 1e-5 in f32;
- the delta pre-pass's plain version (``ops.attention._row_delta``)
  equals ``jnp.sum(g * o, -1)``;
- ``_FlashAttention`` asks the forward kernel for the row log-sum-exp only
  on the kernel path and only when a gradient will follow, and hands it to
  the backward kernel (the kernels stood in for by their plain versions);
- ``_block_grads(impl="cuda")`` refuses CPU tensors;
- the kernel's arithmetic, emulated in plain PyTorch at T 512, meets the
  backward tolerances: P from ``exp(s * scale - lse)`` and every product
  in 3xTF32 (f32), against float64 to 1e-4 * max(1, max|ref|); bf16
  operands with Z and dS rounded to bf16 before their products and f32
  accumulation, against the plain bf16 backward and the plain ring block
  to 2e-2 + 2**-6 relative.  Plain TF32 products miss the f32 tolerance,
  which is why the f32 kernel splits its operands.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as JA
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as TA
from analytics_zoo_tpu_torch.parallel.ring import _block_grads

F32_RTOL = 1e-4                    # x max(1, max|ref|)
BF16_TOL = (2e-2, 2.0 ** -6)       # absolute, relative


def _np(*shapes, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def _plain_block(q, k, v, g, causal, scale, impl="plain"):
    """(dq, dk, dv) of one block through ``_block_grads`` from zero
    accumulators, with the block's own lse and delta."""
    o, lse = TA._reference_attention_with_lse(q, k, v, causal, scale)
    delta = TA._row_delta(o, g)
    acc = [torch.zeros(t.shape, dtype=torch.float32) for t in (q, k, v)]
    _block_grads(q, g, lse, delta, k, v, 0 if causal else None, scale,
                 *acc, impl=impl)
    return acc


@pytest.mark.parametrize("causal", [False, True], ids=["full", "diagonal"])
def test_plain_block_grads_equal_jax_vjp(causal):
    B, H, T, D = 2, 3, 48, 32
    qn, kn, vn, gn = _np(*[(B, H, T, D)] * 4, seed=1)
    scale = 1.0 / math.sqrt(D)
    got = _plain_block(*(torch.from_numpy(a) for a in (qn, kn, vn, gn)),
                       causal, scale)
    _, vjp = jax.vjp(lambda q, k, v: JA._reference_attention(
        q, k, v, causal=causal, sm_scale=scale), qn, kn, vn)
    for name, a, b in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(gn))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_delta_equals_jnp(dtype):
    on, gn = _np((2, 3, 37, 64), (2, 3, 37, 64), seed=2)
    o, g = (torch.from_numpy(a).to(dtype) for a in (on, gn))
    want = jnp.sum(jnp.asarray(g.float().numpy()) *
                   jnp.asarray(o.float().numpy()), -1)
    got = TA._row_delta(o, g)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


def test_block_grads_kernel_path_refuses_cpu_tensors():
    q, k, v, g = (torch.from_numpy(a) for a in _np(*[(1, 2, 16, 32)] * 4))
    with pytest.raises(ValueError, match="CUDA"):
        _plain_block(q, k, v, g, True, 0.2, impl="cuda")


class _StandIns:
    """The two flash kernels' wrappers, stood in for by their plain
    versions, recording whether the forward was asked for lse and what
    lse the backward was given."""

    def __init__(self):
        self.asked, self.given = [], []

    def fwd(self, q, k, v, padding_mask=None, causal=False, sm_scale=1.0,
            dropout_thresh=0, keep_scale=1.0, seed=0, with_lse=False):
        self.asked.append(with_lse)
        o, lse = TA._reference_attention_with_lse(q, k, v, causal, sm_scale)
        return (o, lse) if with_lse else o

    def bwd(self, q, k, v, o, g, lse, padding_mask=None, causal=False,
            sm_scale=1.0, dropout_thresh=0, keep_scale=1.0, seed=0):
        self.given.append(lse)
        return TA._reference_attention_bwd(q, k, v, o, g, padding_mask,
                                           causal, sm_scale)


@pytest.fixture
def stand_ins(monkeypatch):
    s = _StandIns()
    monkeypatch.setattr(_kernels, "flash_fwd", s.fwd)
    monkeypatch.setattr(_kernels, "flash_bwd", s.bwd)
    return s


def _kernel_path(q, k, v, causal=True, scale=0.25):
    """``flash_attention``'s call on the kernel path, on CPU tensors."""
    return TA._FlashAttention.apply(q, k, v, None, causal, scale, 0.0, None,
                                    True, torch.is_grad_enabled())


def test_forward_keeps_lse_for_the_backward_kernel(stand_ins):
    q, k, v, g = (torch.from_numpy(a) for a in _np(*[(2, 2, 24, 32)] * 4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = _kernel_path(*leaves)
    got = torch.autograd.grad(o, leaves, g)
    assert stand_ins.asked == [True]
    _, want_lse = TA._reference_attention_with_lse(q, k, v, True, 0.25)
    assert len(stand_ins.given) == 1
    assert torch.equal(stand_ins.given[0], want_lse)
    want = TA._reference_attention_bwd(q, k, v, o.detach(), g, None, True,
                                       0.25)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_forward_writes_no_lse_without_a_gradient(stand_ins):
    q, k, v = (torch.from_numpy(a) for a in _np(*[(1, 2, 16, 32)] * 3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.inference_mode():
        _kernel_path(*leaves)
    with torch.no_grad():
        _kernel_path(*leaves)
    _kernel_path(q, k, v)              # no input asks for a gradient
    assert stand_ins.asked == [False, False, False]


def test_plain_path_takes_no_kernel_and_no_lse(stand_ins):
    q, k, v, g = (torch.from_numpy(a) for a in _np(*[(2, 2, 24, 32)] * 4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = TA.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(o, leaves, g)
    assert stand_ins.asked == [] and stand_ins.given == []
    want = TA._reference_attention_bwd(q, k, v, o.detach(), g, None, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --- the kernel's arithmetic, emulated ------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared: what a TF32 product reads."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, passes):
    """a @ b as the tensor cores take f32: 1 pass plain TF32, 3 passes
    3xTF32 (lo.hi + hi.lo + hi.hi, f32 accumulation)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = torch.matmul(a_hi, b_hi)
    if passes == 3:
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        out = torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo) + out
    return out


def _emulated_bwd(q, k, v, g, lse, delta, scale, mm, rounded, valid=None):
    """The kernel's backward of one block from the given lse and delta:
    every product through ``mm``, Z and dS through ``rounded`` before
    theirs, P = 0 outside ``valid``; f32 results."""
    s = mm(q, k.transpose(-1, -2))
    p = torch.exp(s * scale - lse[..., None])
    if valid is not None:
        p = torch.where(valid, p, 0.0)
    dp = mm(g, v.transpose(-1, -2))
    ds = rounded(p * (dp - delta[..., None]) * scale)
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(rounded(p).transpose(-1, -2), g))


def _inputs(D, seed=3, B=2, H=2, T=512):
    return [torch.from_numpy(a) for a in _np(*[(B, H, T, D)] * 4,
                                             seed=seed)]


@pytest.mark.parametrize("D", [64, 128])
def test_3xtf32_backward_meets_the_f32_tolerance(D):
    q, k, v, g = _inputs(D)
    scale = 1.0 / math.sqrt(D)
    o, lse = TA._reference_attention_with_lse(q, k, v, False, scale)
    delta = TA._row_delta(o, g)
    want = TA._reference_attention_bwd(*(t.double() for t in (q, k, v, o,
                                                              g)),
                                       sm_scale=scale)
    errs = {}
    for passes in (3, 1):
        got = _emulated_bwd(q, k, v, g, lse, delta, scale,
                            lambda a, b: _mm(a, b, passes), lambda t: t)
        errs[passes] = max(
            ((a.double() - b).abs().max() / max(1.0, b.abs().max())).item()
            for a, b in zip(got, want))
    assert errs[3] <= F32_RTOL, errs
    assert errs[1] > F32_RTOL, errs


def _assert_bf16_close(got, want):
    atol, rtol = BF16_TOL
    for a, b in zip(got, want):
        bad = (a.float() - b.float()).abs() > atol + rtol * b.float().abs()
        assert not bad.any(), (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_rounding_meets_the_bf16_tolerance(causal):
    q, k, v, g = (t.to(torch.bfloat16) for t in _inputs(64, seed=4))
    scale = 1.0 / 8.0
    o, lse = TA._reference_attention_with_lse(q, k, v, causal, scale)
    delta = TA._row_delta(o, g)
    valid = TA._valid((512, 512), "cpu", causal, None)
    got = _emulated_bwd(*(t.float() for t in (q, k, v, g)), lse, delta,
                        scale, torch.matmul,
                        lambda t: t.to(torch.bfloat16).float(), valid)
    # the BERT entry: bf16 gradients against the plain bf16 backward
    want = TA._reference_attention_bwd(q, k, v, o, g, None, causal, scale)
    _assert_bf16_close([t.to(torch.bfloat16) for t in got], want)
    # the ring entry: f32 accumulators against the plain ring block
    _assert_bf16_close(got, _plain_block(q, k, v, g, causal, scale))


def test_library_is_rebuilt_when_a_shared_header_changes(tmp_path,
                                                         monkeypatch):
    # flash_bwd.cu includes hopper.cuh and flash_common.cuh: its library's
    # name hashes them too, so an edited header is never served stale
    for name in os.listdir(_kernels.CSRC):
        with open(os.path.join(_kernels.CSRC, name), "rb") as fh:
            (tmp_path / name).write_bytes(fh.read())
    monkeypatch.setattr(_kernels, "CSRC", str(tmp_path))
    before = _kernels._lib_path("flash_bwd.cu")
    assert before == _kernels._lib_path("flash_bwd.cu")
    assert os.path.dirname(before) == _kernels.BUILD_DIR
    assert os.path.basename(before).startswith("flash_bwd-")
    with open(tmp_path / "hopper.cuh", "a") as fh:
        fh.write("\n")
    assert _kernels._lib_path("flash_bwd.cu") != before
