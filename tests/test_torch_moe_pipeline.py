"""Mixture of experts and the GPipe pipeline against the JAX package's,
on the CPU.

``moe_ffn`` (top-1 Switch routing with a capacity limit, tanh-GELU
experts) and ``pipeline_apply`` (M + S - 1 ticks, stage s at pipeline
coordinate s) run on ``["cpu"] * n`` meshes in the port and on the
8-device CPU mesh in JAX, on the same numpy weights and inputs.
Tolerances (f32): outputs, the aux loss and every gradient 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.parallel import moe as jmoe
from analytics_zoo_tpu.parallel import pipeline as jpipe
from analytics_zoo_tpu_torch.parallel import (
    Mesh, ShardedTensor, device_put, init_moe_params, moe_ffn,
    partition_moe_params, pipeline_apply, stack_stage_params)

ATOL = 1e-5


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(
        np.asarray(jax.devices("cpu")[:n]).reshape(shape), names)


def _mesh(shape, names):
    return Mesh(np.full(shape, "cpu", dtype=object), names)


def _moe_inputs(E=4, d=8, d_ff=16, shape=(4, 8), seed=0):
    params = jax.tree_util.tree_map(np.array, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), d, d_ff, E))
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((*shape, d)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("experts", [1, 2, 4], ids=lambda e: f"ep{e}")
@pytest.mark.parametrize("capacity", [4.0, 0.5], ids=["all", "drops"])
def test_moe_ffn_matches_jax_with_gradients(experts, capacity):
    params, x = _moe_inputs()
    jm = _jmesh((8 // experts, experts), ("data", "expert"))
    mesh = _mesh((1, experts), ("data", "expert"))

    def jloss(p, x_):
        y, aux = jmoe.moe_ffn(p, x_, capacity_factor=capacity, mesh=jm)
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)

    (jl, (jy, jaux)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe_ffn(tp, tx, capacity_factor=capacity, mesh=mesh)
    (torch.mean(y ** 2) + 0.01 * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=ATOL, rtol=0)
    if capacity < 1:          # over-capacity tokens give exact zeros
        assert (y.detach().numpy() == 0).all(-1).sum() > 0
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               atol=ATOL, rtol=0)


def test_moe_over_placed_experts_and_the_gelu_default():
    params, x = _moe_inputs(seed=2)
    mesh = _mesh((4,), ("expert",))
    placed = device_put({k: torch.from_numpy(v) for k, v in params.items()},
                        partition_moe_params(mesh))
    assert isinstance(placed["W1"], ShardedTensor)
    assert [tuple(t.shape) for t in placed["W1"].shards] == [(1, 8, 16)] * 4
    assert len(placed["router"].unique_shards()) == 1
    y, aux = moe_ffn(placed, torch.from_numpy(x), mesh=mesh)
    jy, jaux = jmoe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, params),
                            jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL, rtol=0)
    specs = {k: tuple(s.spec) for k, s in partition_moe_params(mesh).items()}
    jspecs = {k: tuple(s.spec) for k, s in jmoe.partition_moe_params(
        _jmesh((4,), ("expert",))).items()}
    assert specs == jspecs
    with pytest.raises(ValueError, match="do not divide"):
        moe_ffn({k: torch.from_numpy(v) for k, v in params.items()},
                torch.from_numpy(x), mesh=_mesh((3,), ("expert",)))


def test_init_moe_params_draws_the_jax_laws():
    gen = torch.Generator().manual_seed(1)
    p = init_moe_params(gen, 64, 256, 8, device="cpu")
    want = jmoe.init_moe_params(jax.random.PRNGKey(1), 64, 256, 8)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in p.values())
    for k, fan_in in (("router", 64), ("W1", 64), ("W2", 256)):
        assert abs(float(p[k].std()) * np.sqrt(fan_in) - 1) < 0.05, k
    assert not p["b1"].any() and not p["b2"].any()
    again = init_moe_params(torch.Generator().manual_seed(1), 64, 256, 8,
                            device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


# --- the pipeline ---------------------------------------------------------

def _stages(S=4, d=8, seed=0):
    rs = np.random.default_rng(seed)
    return [{"W": (rs.standard_normal((d, d)) * 0.3).astype(np.float32),
             "b": (rs.standard_normal((d,)) * 0.1).astype(np.float32)}
            for _ in range(S)]


@pytest.mark.parametrize("data,M,B", [(2, 4, 16), (1, 4, 16), (2, 3, 9)],
                         ids=["dp2", "dp1", "mb_not_divisible_by_dp"])
def test_pipeline_matches_jax_and_sequential_stages(data, M, B):
    S, d = 4, 8
    stages = _stages(S, d)
    x = np.random.default_rng(9).standard_normal((B, d)).astype(np.float32)
    g = np.random.default_rng(10).standard_normal((B, d)).astype(np.float32)
    jm = _jmesh((data, S), ("data", "pipeline"))
    mesh = _mesh((data, S), ("data", "pipeline"))

    def jloss(p, x_):
        y = jpipe.pipeline_apply(
            lambda q, h: jnp.tanh(h @ q["W"] + q["b"]), p, x_, mesh=jm,
            n_microbatches=M)
        return jnp.sum(y * g), y

    jstacked = jpipe.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, s) for s in stages])
    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True))(
        jstacked, jnp.asarray(x))

    stacked = stack_stage_params(stages)
    assert tuple(stacked["W"].shape) == (S, d, d)
    stacked = {k: v.requires_grad_() for k, v in stacked.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = pipeline_apply(lambda q, h: torch.tanh(h @ q["W"] + q["b"]),
                       stacked, tx, mesh=mesh, n_microbatches=M)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=ATOL, rtol=0)
    seq = torch.from_numpy(x)
    for s in stages:
        seq = torch.tanh(seq @ torch.from_numpy(s["W"])
                         + torch.from_numpy(s["b"]))
    np.testing.assert_allclose(y.detach().numpy(), seq.numpy(), atol=ATOL,
                               rtol=0)
    for k in ("W", "b"):
        np.testing.assert_allclose(stacked[k].grad.numpy(),
                                   np.asarray(jg[0][k]), atol=ATOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               atol=ATOL, rtol=0)


def test_pipeline_over_placed_stages():
    from analytics_zoo_tpu_torch.parallel import NamedSharding, PartitionSpec
    mesh = _mesh((4,), ("pipeline",))
    stacked = stack_stage_params(_stages())
    placed = device_put(stacked, NamedSharding(mesh,
                                               PartitionSpec("pipeline")))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 8)).astype(np.float32))
    fn = lambda q, h: torch.tanh(h @ q["W"] + q["b"])   # noqa: E731
    assert torch.equal(
        pipeline_apply(fn, placed, x, mesh=mesh, n_microbatches=2),
        pipeline_apply(fn, stacked, x, mesh=mesh, n_microbatches=2))


def test_pipeline_errors_match_jax():
    jm = _jmesh((1, 8), ("data", "pipeline"))
    mesh = _mesh((1, 8), ("data", "pipeline"))
    eye = [{"W": np.eye(4, dtype=np.float32)} for _ in range(8)]
    with pytest.raises(ValueError, match="divisible") as got:
        pipeline_apply(lambda p, x: x, stack_stage_params(eye),
                       torch.ones(10, 4), mesh=mesh, n_microbatches=3)
    with pytest.raises(ValueError) as want:
        jpipe.pipeline_apply(lambda p, x: x, jpipe.stack_stage_params(eye),
                             jnp.ones((10, 4)), mesh=jm, n_microbatches=3)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="stages but mesh axis") as got:
        pipeline_apply(lambda p, x: x, stack_stage_params(eye[:4]),
                       torch.ones(8, 4), mesh=mesh, n_microbatches=2)
    with pytest.raises(ValueError) as want:
        jpipe.pipeline_apply(lambda p, x: x,
                             jpipe.stack_stage_params(eye[:4]),
                             jnp.ones((8, 4)), mesh=jm, n_microbatches=2)
    assert str(got.value) == str(want.value)
