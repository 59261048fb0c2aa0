"""Helpers of the port's layer parity tests: one layer built in both
packages on the same numpy input, the JAX weights loaded into the port's
layer, forwards and gradients compared."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from analytics_zoo_tpu_torch import interop

ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(*shape, seed=0, positive=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(x) + 0.1 if positive else x


def _perturb(tree, seed=7):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + np.asarray(
            0.1 * rs.randn(*np.shape(p)), np.float32)), tree)


def _shape(x):
    if isinstance(x, list):
        return [(None,) + a.shape[1:] for a in x]
    return (None,) + x.shape[1:]


def _torch_in(x, grad=False):
    if isinstance(x, list):
        return [torch.tensor(a, requires_grad=grad) for a in x]
    return torch.tensor(x, requires_grad=grad)


def check_layer(jlayer, tlayer, x, grad=True, atol=ATOL):
    """Forward (and, with ``grad``, the gradients of ``sum(y * r)`` with
    respect to the input and every weight) of both layers on ``x``;
    returns the port's output."""
    params, state = jlayer.build(jax.random.PRNGKey(1), _shape(x))
    params = _perturb(params)
    jx = [jnp.asarray(a) for a in x] if isinstance(x, list) else \
        jnp.asarray(x)
    want = jlayer.call(params, state, jx, False, None)[0]
    tlayer.ensure_built(_shape(x))
    interop.load_jax_params(tlayer, _np(params), _np(state))
    tx = _torch_in(x, grad)
    got = tlayer(tx)
    outs = got if isinstance(got, list) else [got]
    wants = want if isinstance(want, list) else [want]
    for g, w in zip(outs, wants):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=atol, rtol=0)
    if not grad:
        return got
    rs = np.random.RandomState(3)
    rs_out = [rs.randn(*np.shape(w)).astype(np.float32) for w in wants]

    def jloss(p, xin):
        y = jlayer.call(p, state, xin, False, None)[0]
        ys = y if isinstance(y, list) else [y]
        return sum(jnp.sum(a * r) for a, r in zip(ys, rs_out))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jx)
    sum((o * torch.from_numpy(r)).sum() for o, r in zip(outs, rs_out)
        ).backward()
    for t, w in zip(tx if isinstance(tx, list) else [tx],
                    gx if isinstance(gx, list) else [gx]):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=0)
    flat = interop._flatten(_np(gp))
    for name, p in tlayer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), flat[name], atol=atol,
                                   rtol=0, err_msg=name)
    return got
