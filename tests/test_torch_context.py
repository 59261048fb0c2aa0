"""The port's process-wide context against the JAX package's, on the CPU.

Both packages keep one context per process: ``init_zoo_context`` returns
it on a second call, ``get_context`` builds it on first use,
``current_context`` only peeks, ``context_scope`` / ``device_scope`` pin a
context for the calling thread, and ``reset_context`` / ``set_context``
replace it.  Each test drives the same sequence through both packages
(the JAX side on the 8-device CPU mesh of ``tests/conftest.py``, which
also resets the JAX context around each test) and compares what it sees:
identities, mesh shapes and the errors.  The port's context is reset
around each test here, and a test that sets one resets it in a
``finally``.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common.config import (
    MeshConfig as JMeshConfig, ZooConfig as JZooConfig)
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu_torch.parallel import ShardedTensor

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _fresh_port_context():
    tctx.reset_context()
    yield
    tctx.reset_context()


def _both(data=-1, model=1):
    """(JAX context, port context) of one mesh config over 8 devices."""
    jc = jctx.init_zoo_context(JZooConfig(mesh=JMeshConfig(data=data,
                                                           model=model)))
    tc = tctx.init_zoo_context(ZooConfig(mesh=MeshConfig(data=data,
                                                         model=model)),
                               devices=CPU8)
    assert tc.mesh.shape == dict(jc.mesh.shape)
    return jc, tc


def test_second_init_returns_the_first_context():
    jc, tc = _both(data=4, model=2)
    # a second call ignores its arguments in both packages
    assert jctx.init_zoo_context(JZooConfig()) is jc
    assert tctx.init_zoo_context(ZooConfig(), devices=["cpu"]) is tc
    assert tctx.get_context() is tc and jctx.get_context() is jc
    assert tctx.current_context() is tc and jctx.current_context() is jc
    assert (tc.num_devices, tc.axis_size("model"), tc.global_batch_divisor,
            tc.data_axis) == (jc.num_devices, jc.axis_size("model"),
                              jc.global_batch_divisor, jc.data_axis)
    assert tc.platform == "cpu" and jc.platform == "cpu"


def test_current_context_peeks_without_building_one():
    assert jctx.current_context() is None
    assert tctx.current_context() is None
    assert tctx.current_context() is None      # still none: nothing built


def test_get_context_builds_the_default_one():
    jc = jctx.get_context()
    assert jctx.current_context() is jc
    # the port's default context lies on the card: without one it raises,
    # and a CPU platform builds it on the host
    if not torch.cuda.is_available():
        with pytest.raises(tctx.NoCudaDeviceError):
            tctx.get_context()
        assert tctx.current_context() is None
    tc = tctx.init_zoo_context(ZooConfig(platform="cpu"))
    assert tctx.get_context() is tc and tc.mesh.shape["data"] == 1


def test_reset_and_set_context():
    jc, tc = _both()
    jctx.reset_context()
    tctx.reset_context()
    assert jctx.current_context() is None and tctx.current_context() is None
    jc2, tc2 = _both(data=2, model=4)
    assert tc2 is not tc and jc2 is not jc
    tctx.set_context(tc)
    jctx.set_context(jc)
    assert tctx.get_context() is tc and jctx.get_context() is jc
    assert tctx.init_zoo_context() is tc


def test_context_scope_pins_the_calling_thread_only():
    jc, tc = _both()
    other_t = tctx.ZooContext(ZooConfig(), tctx._build_mesh(
        [torch.device("cpu")] * 2, MeshConfig(data=1, model=2)))
    other_j = jctx.ZooContext(JZooConfig(), jctx._build_mesh(
        jax.devices("cpu")[:2], JMeshConfig(data=1, model=2)))
    seen = {}

    def peek():
        seen["t"] = tctx.current_context()
        seen["j"] = jctx.current_context()

    with tctx.context_scope(other_t) as got_t, \
            jctx.context_scope(other_j) as got_j:
        assert got_t is other_t and got_j is other_j
        assert tctx.get_context() is other_t
        assert jctx.get_context() is other_j
        th = threading.Thread(target=peek)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
        # a nested scope restores the outer one on exit
        with tctx.context_scope(tc):
            assert tctx.current_context() is tc
        assert tctx.current_context() is other_t
    assert seen == {"t": tc, "j": jc}
    assert tctx.current_context() is tc and jctx.current_context() is jc


def test_device_scope_is_data_parallel_over_its_devices():
    jc, tc = _both(data=2, model=4)
    with tctx.device_scope(["cpu"] * 3) as ts, \
            jctx.device_scope(jax.devices("cpu")[:3]) as js:
        assert ts.mesh.shape == dict(js.mesh.shape)
        assert ts.mesh.shape == {"data": 3, "model": 1, "sequence": 1,
                                 "expert": 1, "pipeline": 1}
        assert ts.config.compute_dtype == tc.config.compute_dtype
        assert tctx.get_context() is ts and jctx.get_context() is js
    assert tctx.get_context() is tc and jctx.get_context() is jc
    one = tctx.device_scope("cpu")          # a single device, not a list
    assert one._ctx.mesh.size == 1
    with pytest.raises(ValueError, match="at least one device") as got:
        tctx.device_scope([])
    with pytest.raises(ValueError) as want:
        jctx.device_scope([])
    assert str(got.value) == str(want.value)


def test_reset_clears_the_thread_scope():
    _, tc = _both()
    with tctx.context_scope(tc):
        tctx.reset_context()
        assert tctx.current_context() is None


def test_sharding_helpers_match_jax_specs():
    jc, tc = _both(data=4, model=2)
    for got, want in ((tc.data_sharding, jc.data_sharding),
                      (tc.replicated, jc.replicated),
                      (tc.sharding(None, "model"), jc.sharding(None,
                                                               "model"))):
        assert tuple(got.spec) == tuple(want.spec)
        for shape in ((8, 6), (16, 4)):
            assert got.shard_shape(shape) == want.shard_shape(shape)
    tree = {"w": np.arange(24, dtype=np.float32).reshape(8, 3),
            "b": [np.ones(3, np.float32)]}
    placed = tc.replicate(tree)
    want = jc.replicate(tree)
    assert isinstance(placed["w"], ShardedTensor)
    assert len(placed["w"].shards) == 8
    # positions on one device share one tensor
    assert len(placed["w"].unique_shards()) == 1
    np.testing.assert_array_equal(placed["w"].gather().numpy(),
                                  np.asarray(want["w"]))
    np.testing.assert_array_equal(placed["b"][0].gather().numpy(),
                                  np.asarray(want["b"][0]))
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    from analytics_zoo_tpu_torch.parallel import device_put
    got = device_put(x, tc.data_sharding)
    jx = jax.device_put(x, jc.data_sharding)
    for p, (shard, dev) in enumerate(zip(got.shards,
                                         tc.mesh.devices.flat)):
        jshard = next(s for s in jx.addressable_shards
                      if s.device == jc.mesh.devices.flat[p])
        np.testing.assert_array_equal(shard.numpy(), np.asarray(jshard.data))
        assert shard.is_contiguous() and shard.device == dev
