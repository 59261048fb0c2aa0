"""The port's ring attention against the JAX package's, on the CPU.

Both rings run in this one process on eight shards: the JAX one over the
8-device virtual CPU mesh of ``tests/conftest.py``, the port's over
``init_zoo_context(devices=["cpu"] * 8)``, the same mesh rule.  No process
group, socket or child process.  The JAX side runs its Pallas block kernel
in interpret mode (``impl="pallas"``) and its jnp blocks; the port runs its
plain blocks, the ones its CUDA kernel is held to on the card.  Inputs come
from a numpy seed and cross as numpy arrays.  Tolerances (f32): the plain
lse attention 1e-6 (same formula, tiny blocks); the Pallas block and the
ring outputs 1e-5 (other summation orders over up to 256 keys);
gradients 1e-4 (five products per block, summed over the ring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx_mod
from analytics_zoo_tpu.common.config import (
    MeshConfig as JMeshConfig, ZooConfig as JZooConfig)
from analytics_zoo_tpu.ops import attention as JA
from analytics_zoo_tpu.parallel import ring_attention as jax_ring
from analytics_zoo_tpu_torch import parallel
from analytics_zoo_tpu_torch.common import context as tctx_mod
from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as TA
from analytics_zoo_tpu_torch.parallel import Mesh, ring_attention
from analytics_zoo_tpu_torch.parallel.ring import _Layout


@pytest.fixture(autouse=True)
def _fresh_port_context():
    """The port's context is process-wide, as the JAX package's is: each
    test starts and ends without one."""
    from analytics_zoo_tpu_torch.common.context import reset_context
    reset_context()
    yield
    reset_context()

CPU8 = ["cpu"] * 8


def _inputs(*shapes, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def _meshes(sequence):
    """(JAX mesh, port mesh) of data -1 x sequence over eight devices."""
    cfg = JZooConfig()
    cfg.mesh.data, cfg.mesh.sequence = -1, sequence
    jmesh = jctx_mod.init_zoo_context(cfg).mesh
    ctx = tctx_mod.init_zoo_context(
        ZooConfig(mesh=MeshConfig(data=-1, sequence=sequence)), devices=CPU8)
    assert ctx.mesh.shape == dict(jmesh.shape)
    return jmesh, ctx.mesh


# --- the plain lse attention and the block kernel's CPU path -------------

@pytest.mark.parametrize("case", [
    dict(Tq=16, Tk=16, causal=False),
    dict(Tq=12, Tk=20, causal=True),                 # end-aligned Tq < Tk
    dict(Tq=20, Tk=12, causal=True),                 # rows with no key
    dict(Tq=16, Tk=16, causal=True, shift=16),       # a past ring block
    dict(Tq=16, Tk=16, causal=True, shift=0),        # the own block
    dict(Tq=16, Tk=16, causal=True, shift=-16),      # a future block
], ids=["full", "causal_tq_lt_tk", "causal_empty_rows", "shift_past",
        "shift_diag", "shift_future"])
def test_reference_attention_with_lse_matches_jax(case):
    Tq, Tk = case["Tq"], case["Tk"]
    q, k, v = _inputs((2, 3, Tq, 16), (2, 3, Tk, 16), (2, 3, Tk, 16))
    shift = case.get("shift")
    o, lse = TA._reference_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), case["causal"], 0.25, shift=shift)
    jo, jlse = JA._reference_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), case["causal"], 0.25,
        shift=None if shift is None else jnp.int32(shift))
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-6,
                               rtol=1e-6)
    visible = (np.arange(Tq)[:, None] + (Tk - Tq if shift is None else shift)
               >= np.arange(Tk)[None, :]).any(-1)
    if case["causal"] and not visible.all():
        assert np.all(lse.numpy()[:, :, ~visible] == np.float32(-1e30))
        assert np.all(o.numpy()[:, :, ~visible] == 0.0)


@pytest.mark.parametrize("Tq,Tk,causal", [
    (128, 128, False), (128, 128, True), (128, 256, True), (256, 256, False),
], ids=["full_128", "diag_128", "causal_tq_lt_tk", "full_256"])
def test_flash_forward_with_lse_matches_jax_pallas(Tq, Tk, causal):
    q, k, v = _inputs((1, 2, Tq, 64), (1, 2, Tk, 64), (1, 2, Tk, 64), seed=1)
    o, lse = TA.flash_forward_with_lse(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal)
    jo, jlse = JA.flash_forward_with_lse(*map(jnp.asarray, (q, k, v)),
                                         causal=causal, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=0)


def test_flash_forward_with_lse_never_sends_cpu_tensors_to_the_kernel():
    q, k, v = map(torch.from_numpy, _inputs(*[(1, 2, 8, 32)] * 3))
    before = _kernels.flash_fwd_lse.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.flash_forward_with_lse(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        _kernels.flash_fwd_lse(q, k, v)
    with pytest.raises(ValueError, match="backend"):
        TA.flash_forward_with_lse(q, k, v, backend="pallas")
    assert _kernels.flash_fwd_lse.launches == before
    plain = TA.flash_forward_with_lse(q, k, v, backend="plain")
    auto = TA.flash_forward_with_lse(q, k, v)
    for a, b in zip(plain, auto):
        assert torch.equal(a, b)


# --- the ring, forward and backward --------------------------------------

@pytest.mark.parametrize("jax_impl", ["pallas", "jnp"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sequence", [4, 2], ids=["sp4_dp2", "sp2_dp4"])
def test_ring_matches_jax(sequence, causal, jax_impl):
    jmesh, mesh = _meshes(sequence)
    q, k, v = _inputs(*[(2, 2, 64, 16)] * 3, seed=2)
    out = ring_attention(*map(torch.from_numpy, (q, k, v)), mesh,
                         causal=causal)
    want = jax_ring(*map(jnp.asarray, (q, k, v)), jmesh, causal=causal,
                    impl=jax_impl)
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("sequence", [4, 2], ids=["sp4_dp2", "sp2_dp4"])
def test_ring_gradients_match_jax(sequence, causal):
    jmesh, mesh = _meshes(sequence)
    q, k, v, w = _inputs(*[(2, 2, 32, 8)] * 4, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    loss = (ring_attention(*leaves, mesh, causal=causal)
            * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(loss, leaves)

    def f(q, k, v):
        return jnp.sum(jax_ring(q, k, v, jmesh, causal=causal)
                       * jnp.asarray(w))

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for name, a, b in zip("qkv", got, want):
        assert a.shape == q.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0, err_msg=f"d{name}")


def test_ring_bf16_matches_jax_jnp():
    jmesh, mesh = _meshes(4)
    q, k, v = _inputs(*[(2, 2, 32, 16)] * 3, seed=4)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    out = ring_attention(bf(q), bf(k), bf(v), mesh, causal=True)
    want = jax_ring(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    jmesh, causal=True, impl="jnp")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=0)


def test_ring_splits_batch_only_when_it_divides():
    mesh = tctx_mod.init_zoo_context(
        ZooConfig(mesh=MeshConfig(data=2, sequence=4)), devices=CPU8).mesh
    two = _Layout(mesh, "sequence", "data", B=4, T=64)
    assert (len(two.rings), len(two.rings[0]), two.B_loc, two.T_loc) == (
        2, 4, 2, 16)
    one = _Layout(mesh, "sequence", "data", B=3, T=64)
    assert (len(one.rings), one.B_loc) == (1, 3)
    assert len(_Layout(mesh, "sequence", None, B=4, T=64).rings) == 1


def test_ring_refuses_what_it_does_not_take():
    mesh = Mesh(["cpu"] * 4, ("sequence",))
    q = torch.zeros(1, 1, 12, 8)
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(torch.zeros(1, 1, 10, 8), q[:, :, :10], q[:, :, :10],
                       mesh)
    with pytest.raises(ValueError, match="no mesh axis"):
        ring_attention(q, q, q, mesh, axis_name="model")
    with pytest.raises(ValueError, match="impl must be one of"):
        ring_attention(q, q, q, mesh, impl="xla")
    for impl in ("pallas", "cuda"):       # the kernels, not on CPU shards
        with pytest.raises(ValueError, match="CUDA tensors"):
            ring_attention(q, q, q, mesh, impl=impl)


# --- the mesh and the context --------------------------------------------

@pytest.mark.parametrize("mesh", [
    dict(data=-1, model=-1),
    dict(data=-1, model=3),
    dict(data=3, model=2),
], ids=["two_fill_axes", "not_divisible", "does_not_cover"])
def test_mesh_errors_match_jax(mesh):
    with pytest.raises(ValueError) as want:
        jctx_mod._build_mesh(jax.devices("cpu"), JMeshConfig(**mesh))
    with pytest.raises(ValueError) as got:
        tctx_mod._build_mesh([torch.device("cpu")] * 8, MeshConfig(**mesh))
    assert str(got.value) == str(want.value)


def test_mesh_places_repeated_devices_by_coordinate():
    mesh = Mesh([["cpu", "meta"], ["cpu", "meta"]], ("data", "sequence"))
    assert mesh.shape == {"data": 2, "sequence": 2} and mesh.size == 4
    assert mesh.device({"data": 1, "sequence": 1}) == torch.device("meta")
    assert mesh.device({"data": 1}) == torch.device("cpu")
    with pytest.raises(ValueError, match="no mesh axis"):
        mesh.device({"model": 0})
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 4, ("data", "sequence"))
    with pytest.raises(ValueError, match="differ"):
        Mesh([["cpu"]], ("data", "data"))


def test_init_zoo_context_lays_out_devices_by_the_config():
    ctx = tctx_mod.init_zoo_context(
        ZooConfig(mesh=MeshConfig(data=2, sequence=2, model=-1)),
        devices=["cpu"] * 8)
    assert ctx.mesh.shape == {"data": 2, "model": 2, "sequence": 2,
                              "expert": 1, "pipeline": 1}
    assert ctx.num_devices == 8 and ctx.axis_size("model") == 2
    assert ctx.axis_size("absent") == 1
    assert tctx_mod.init_zoo_context(devices=["cpu"]) is ctx  # idempotent
    tctx_mod.reset_context()
    assert tctx_mod.init_zoo_context(devices=["cpu"]).mesh.shape["data"] == 1


@pytest.mark.parametrize("name", [
    "partition_params", "partition_specs", "ShardingRule", "init_moe_params",
    "moe_ffn", "partition_moe_params", "pipeline_apply", "stack_stage_params",
    "bytes_per_device", "replicated_shardings", "tree_bytes",
    "zero_partition_spec", "zero_shardings"])
def test_unported_parallel_exports_raise_naming_roadmap(name):
    # ported since: each export is its module's function, no stub that
    # raises naming ROADMAP, and the package exports it as JAX's does
    import analytics_zoo_tpu.parallel as jparallel
    fn = getattr(parallel, name)
    assert fn.__module__.startswith("analytics_zoo_tpu_torch.parallel.")
    assert fn.__module__.rsplit(".", 1)[1] == getattr(
        jparallel, name).__module__.rsplit(".", 1)[1]
    assert name in parallel.__all__
