"""The port's attention backward against the JAX package's, on the CPU.

The JAX side takes ``jax.vjp`` through ``flash_attention(backend="pallas")``
in interpret mode: with ``block_k >= Tk`` its backward is the Pallas
``_bwd_kernel_single`` (via ``_bwd_single_pallas``), with ``block_k < Tk``
the jnp ``_blockwise_bwd``.  The port's side is ``flash_attention`` on CPU
tensors, whose backward is ``_reference_attention_bwd``, the plain version
the CUDA kernel is held to on the card.  Inputs and the output gradient
come from a numpy seed.  f32 tolerance 1e-5 absolute, 2e-4 with dropout
(the bar of the JAX suite's own ``test_ops_attention.py:127-129``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import attention as JA
from analytics_zoo_tpu_torch.ops import attention as TA

CASES = {
    "padding_mask": dict(B=3, Tq=16, Tk=24, mask=True),
    "causal_tq_lt_tk": dict(B=2, Tq=16, Tk=24, causal=True),
    "dropout": dict(B=3, Tq=16, Tk=24, mask=True, dropout_rate=0.2,
                    dropout_seed=1234),
    "causal_mask_dropout": dict(B=3, Tq=8, Tk=24, mask=True, causal=True,
                                dropout_rate=0.1, dropout_seed=-7),
}


def _case(B, Tq, Tk, H=2, D=16, mask=False, seed=0, **kw):
    rs = np.random.default_rng(seed)
    mk = lambda T: rs.standard_normal((B, H, T, D)).astype(np.float32)
    q, k, v, g = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    pm = None
    if mask:
        lens = [Tk, 5, 0, 3][:B]                 # the third row is empty
        pm = (np.arange(Tk)[None] < np.array(lens)[:, None]).astype(np.int32)
    return (q, k, v, g, pm), kw


def _port_grads(q, k, v, g, pm, **kw):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = TA.flash_attention(qt, kt, vt, padding_mask=None if pm is None
                           else torch.from_numpy(pm), **kw)
    return [t.numpy() for t in torch.autograd.grad(
        o, (qt, kt, vt), torch.from_numpy(g))]


def _jax_grads(q, k, v, g, pm, block_k, **kw):
    fn = lambda q, k, v: JA.flash_attention(
        q, k, v, padding_mask=None if pm is None else jnp.asarray(pm),
        backend="pallas", block_q=8, block_k=block_k, **kw)
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("path", ["single_pallas", "blockwise"])
def test_backward_matches_jax(case, path, monkeypatch):
    (q, k, v, g, pm), kw = _case(**CASES[case])
    calls = []
    single = JA._bwd_single_pallas
    monkeypatch.setattr(JA, "_bwd_single_pallas",
                        lambda *a, **k: calls.append(1) or single(*a, **k))
    block_k = k.shape[2] if path == "single_pallas" else 8
    want = _jax_grads(q, k, v, g, pm, block_k, **kw)
    assert len(calls) == (1 if path == "single_pallas" else 0)
    got = _port_grads(q, k, v, g, pm, **kw)
    atol = 2e-4 if kw.get("dropout_rate") else 1e-5
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES) + ["causal_tq_gt_tk"])
def test_plain_backward_matches_autograd(case):
    spec = CASES.get(case, dict(B=2, Tq=24, Tk=16, causal=True))
    (q, k, v, g, pm), kw = _case(**spec)
    t = lambda a: None if a is None else torch.from_numpy(a)
    qt, kt, vt = (t(a).requires_grad_() for a in (q, k, v))
    o = TA._reference_attention(qt, kt, vt, t(pm), kw.get("causal", False),
                                None, kw.get("dropout_rate", 0.0),
                                kw.get("dropout_seed"))
    want = torch.autograd.grad(o, (qt, kt, vt), t(g))
    got = TA._reference_attention_bwd(
        t(q), t(k), t(v), o.detach(), t(g), t(pm), kw.get("causal", False),
        None, kw.get("dropout_rate", 0.0), kw.get("dropout_seed"))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_rows_without_keys_get_zero_gradients():
    (q, k, v, g, pm), _ = _case(B=3, Tq=16, Tk=24, mask=True)
    dq, dk, dv = _port_grads(q, k, v, g, pm)
    assert np.all(dq[2] == 0)                       # fully masked batch row
    assert np.all(dk[1, :, 5:] == 0) and np.all(dv[1, :, 5:] == 0)
    (q, k, v, g, _), _ = _case(B=2, Tq=24, Tk=16)
    dq, _, _ = _port_grads(q, k, v, g, None, causal=True)
    assert np.all(dq[:, :, :8] == 0)                # causal rows, no key


def test_bf16_backward_keeps_dtype_and_tracks_f32():
    (q, k, v, g, pm), _ = _case(B=3, Tq=16, Tk=24, mask=True)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    o = TA.flash_attention(bf(q), bf(k), bf(v), torch.from_numpy(pm))
    got = TA._reference_attention_bwd(bf(q), bf(k), bf(v), o, bf(g),
                                      torch.from_numpy(pm))
    want = _port_grads(q, k, v, g, pm)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b, atol=6e-2, rtol=0)
