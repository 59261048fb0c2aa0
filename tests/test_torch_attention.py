"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode (as
``tests/test_ops_attention.py`` does) and its jnp reference; the port runs
its plain PyTorch version, the one its CUDA kernel is held to on the card.
Inputs come from a numpy seed and cross as numpy arrays.  f32 tolerance:
1e-5 absolute, for accumulation-order differences at T <= 24.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as JA
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as TA

ATOL = 1e-5


def _inputs(B=2, H=2, Tq=16, Tk=16, D=16, seed=0):
    rs = np.random.default_rng(seed)
    mk = lambda T: rs.standard_normal((B, H, T, D)).astype(np.float32)
    return mk(Tq), mk(Tk), mk(Tk)


def _ragged_mask(B, Tk):
    """Valid lengths Tk, 5, 0, ...: the third row is fully masked."""
    lens = [Tk, 5, 0, 3][:B]
    return (np.arange(Tk)[None] < np.array(lens)[:, None]).astype(np.int32)


def _port(q, k, v, mask=None, **kw):
    t = lambda a: None if a is None else torch.from_numpy(a)
    return TA.flash_attention(t(q), t(k), t(v), padding_mask=t(mask),
                              **kw).numpy()


def _jax_pallas(q, k, v, mask=None, **kw):
    return np.asarray(JA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        padding_mask=None if mask is None else jnp.asarray(mask),
        backend="pallas", block_q=8, block_k=8, **kw))


def _jax_reference(q, k, v, mask=None, causal=False, dropout_rate=0.0,
                   dropout_seed=None):
    return np.asarray(JA._reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        padding_mask=None if mask is None else jnp.asarray(mask),
        causal=causal, dropout_p=dropout_rate,
        dropout_seed=None if dropout_seed is None
        else jnp.asarray(dropout_seed, jnp.int32)))


CASES = {
    "plain": dict(shape=dict(), kw={}),
    "padding_mask": dict(shape=dict(B=3, Tk=24), mask=True, kw={}),
    "causal_tq_lt_tk": dict(shape=dict(Tq=16, Tk=24), kw=dict(causal=True)),
    "dropout": dict(shape=dict(B=3, Tk=24), mask=True,
                    kw=dict(dropout_rate=0.2, dropout_seed=1234)),
    "causal_mask_dropout": dict(shape=dict(B=3, Tq=8, Tk=24), mask=True,
                                kw=dict(causal=True, dropout_rate=0.1,
                                        dropout_seed=-7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_pallas_and_reference(case):
    c = CASES[case]
    q, k, v = _inputs(**c["shape"])
    mask = _ragged_mask(q.shape[0], k.shape[2]) if c.get("mask") else None
    out = _port(q, k, v, mask, **c["kw"])
    assert out.shape == q.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, _jax_pallas(q, k, v, mask, **c["kw"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, _jax_reference(q, k, v, mask, **c["kw"]),
                               atol=ATOL, rtol=0)


def test_fully_masked_row_is_zero():
    q, k, v = _inputs(B=3, Tk=24)
    out = _port(q, k, v, _ragged_mask(3, 24))
    assert np.all(out[2] == 0.0)


def test_causal_tq_gt_tk_rows_without_keys_are_zero_like_the_kernel():
    # rows that see no key at all: the JAX Pallas kernel gives zeros (its
    # jnp reference a uniform average); the port follows the kernel
    q, k, v = _inputs(Tq=24, Tk=16)
    out = _port(q, k, v, causal=True)
    np.testing.assert_allclose(out, _jax_pallas(q, k, v, causal=True),
                               atol=ATOL, rtol=0)
    assert np.all(out[:, :, :8] == 0.0)


def test_bf16_matches_jax_reference():
    q, k, v = _inputs(B=3, Tk=24)
    mask = _ragged_mask(3, 24)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    out = TA.flash_attention(bf(q), bf(k), bf(v),
                             padding_mask=torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    ref = JA._reference_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), padding_mask=jnp.asarray(mask))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize("seed", [0, 1234, -7, 2**31 - 1, -2**31])
def test_keep_mask_bit_identical(seed):
    shape = (2, 3, 17, 33)
    jm = np.asarray(JA._hash_keep_mask(seed, shape, 0.3))
    tm = TA._hash_keep_mask(seed, shape, 0.3).numpy()
    assert tm.dtype == np.bool_ and np.array_equal(jm, tm)
    assert 0.6 < tm.mean() < 0.8
    bh = np.arange(6, dtype=np.int32)[:, None, None]
    qi = np.arange(17, dtype=np.int32)[None, :, None]
    ki = np.arange(33, dtype=np.int32)[None, None, :]
    jbits = np.asarray(JA._dropout_bits(jnp.int32(seed), jnp.asarray(bh),
                                        jnp.asarray(qi), jnp.asarray(ki)))
    tbits = TA._dropout_bits(seed, torch.from_numpy(bh),
                             torch.from_numpy(qi), torch.from_numpy(ki))
    assert np.array_equal(jbits.view(np.uint32),
                          tbits.numpy().astype(np.uint32))


def test_dropout_thresh_matches():
    for rate in (0.0, 0.1, 0.25, 0.999):
        assert TA._dropout_thresh(rate) == JA._dropout_thresh(rate)


def test_no_seed_means_no_dropout():
    q, k, v = _inputs()
    np.testing.assert_array_equal(_port(q, k, v, dropout_rate=0.5),
                                  _port(q, k, v))


def test_cpu_tensors_never_reach_the_kernel():
    q, k, v = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.flash_attention(q, k, v, backend="pallas")
    with pytest.raises(ValueError, match="dropout_rate"):
        TA.flash_attention(q, k, v, dropout_rate=1.0)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_kernels, "DEFAULT_NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    with pytest.raises(_kernels.KernelBuildError, match="nvcc"):
        _kernels._nvcc()
