"""Per-host sharded checkpoints across the two packages, on the CPU.

The per-host layout (``save_checkpoint(per_host=True)``) writes every
sharded leaf as its shards, ``shards.h<p>.npz`` and ``shardidx.h<p>.pkl``
a process; restore merges them into full arrays.  Checked both ways: what
the JAX package writes (its 8-device CPU mesh) the port reads, and what
the port writes (``ShardedTensor``s of ``["cpu"] * 8``) the port reads, a
missing host file failing loudly and a bf16 leaf keeping its bits.  Then
the estimators: a JAX per-host checkpoint of the 2D-sharded ``TinyTx``
resumed by the port, and the port's own per-host checkpoint restored onto
other mesh shapes (dp 8, dp 2 x mp 4, replicated), each continuing to the
JAX run of the uninterrupted mesh (weights rtol 2e-5 / atol 2e-6).  The
JAX side runs only on its full mesh, with its persistent compile cache
off.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import analytics_zoo_tpu.estimator.estimator as jest_mod
import analytics_zoo_tpu_torch.estimator.estimator as test_mod
from analytics_zoo_tpu.data import FeatureSet as JFeatureSet
from analytics_zoo_tpu.estimator import Estimator as JEstimator
from analytics_zoo_tpu.estimator import checkpoint as JC
from analytics_zoo_tpu.keras import optimizers as JO
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.data import FeatureSet
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.estimator import checkpoint as TC
from analytics_zoo_tpu_torch.keras import optimizers as TO
from analytics_zoo_tpu_torch.parallel import (
    Mesh, NamedSharding, PartitionSpec as P, bytes_per_device, device_put,
    tree_bytes)
from test_torch_mesh_train import (
    JTinyTx, TinyTx, WEIGHT_TOL, _flat, _jctx, _same_weights, _tctx,
    _tiny_data, _tiny_tree)


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compile_cache():
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", prev)


@pytest.fixture(autouse=True)
def _fresh_contexts():
    tctx.reset_context()
    yield
    tctx.reset_context()


def _jax_mesh():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                             ("data", "model"))


def _port_mesh():
    return Mesh(np.full((4, 2), "cpu", dtype=object), ("data", "model"))


def _arrays():
    w = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    b = np.arange(96, dtype=np.float32)
    mu = (np.arange(32, dtype=np.float32).reshape(8, 4) / 7)
    return w, b, mu


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_the_port_reads_a_jax_per_host_checkpoint(tmp_path):
    w, b, mu = _arrays()
    mesh = _jax_mesh()
    put = lambda a, spec: jax.device_put(a, JNamedSharding(mesh, spec))
    bf = jnp.asarray(mu, jnp.bfloat16)
    params = {"w": put(w, JP("data", None)), "b": put(b, JP("model")),
              "mu": put(bf, JP("data")), "r": jnp.ones((3,))}
    path = JC.save_checkpoint(str(tmp_path), 7,
                              (params, {}, {}, {"epoch": 3}), per_host=True)
    assert {"shards.h0.npz", "shardidx.h0.pkl"} <= set(os.listdir(path))
    (got, _, _, meta), step = TC.restore_checkpoint(path)
    assert step == 7 and meta == {"epoch": 3}
    np.testing.assert_array_equal(got["w"].numpy(), w)
    np.testing.assert_array_equal(got["b"].numpy(), b)
    np.testing.assert_array_equal(got["r"].numpy(), np.ones(3))
    assert got["mu"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["mu"]),
                                  np.asarray(bf).view(np.uint16))


def test_a_missing_jax_host_file_fails_loudly(tmp_path):
    mesh = _jax_mesh()
    w = jax.device_put(jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
                       JNamedSharding(mesh, JP("data")))
    path = JC.save_checkpoint(str(tmp_path), 1, ({"w": w}, {}, {}, {}),
                              per_host=True)
    os.remove(os.path.join(path, "shards.h0.npz"))
    os.remove(os.path.join(path, "shardidx.h0.pkl"))
    with pytest.raises(ValueError, match="does not cover leaf") as got:
        TC.restore_checkpoint(path)
    with pytest.raises(ValueError, match="does not cover leaf") as want:
        JC.restore_checkpoint(path)
    assert str(got.value) == str(want.value)


def _placed():
    w, b, mu = _arrays()
    mesh = _port_mesh()
    put = lambda a, spec: device_put(a, NamedSharding(mesh, spec))
    return {"w": put(torch.from_numpy(w), P("data", None)),
            "b": put(torch.from_numpy(b), P("model")),
            "mu": put(torch.from_numpy(mu).to(torch.bfloat16), P("data")),
            "r": put(torch.ones(3), P())}


def test_port_per_host_round_trip(tmp_path):
    bundle = _placed()
    assert not TC.needs_per_host(bundle)      # one process holds them all
    path = TC.save_checkpoint(str(tmp_path), 7,
                              (bundle, {}, {}, {"epoch": 3}), per_host=True)
    files = set(os.listdir(path))
    assert {"shards.h0.npz", "shardidx.h0.pkl", "COMPLETE"} <= files
    (got, _, _, meta), step = TC.restore_checkpoint(path)
    assert step == 7 and meta == {"epoch": 3}
    for name in ("w", "b", "r"):
        assert torch.equal(got[name], bundle[name].gather()), name
    assert got["mu"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["mu"]),
                                  _bits(bundle["mu"].gather()))
    # the replicated leaf stays in leaves.npz; the sharded ones are shards
    with open(os.path.join(path, "treedef.pkl"), "rb") as fh:
        partial = TC._StubUnpickler(fh).load()["partial"]
    assert sorted(p["shape"] for p in partial.values()) == \
        [(8, 4), (8, 6), (96,)]
    # the JAX package reads the port's shard files
    idx = sorted(os.listdir(path))
    assert idx == sorted(["COMPLETE", "leaves.npz", "shardidx.h0.pkl",
                          "shards.h0.npz", "treedef.pkl"])
    want = JC._merge_host_shards(path, partial)
    for i, arr in TC._merge_host_shards(path, partial).items():
        np.testing.assert_array_equal(arr, np.asarray(want[i]).view(
            arr.dtype))


def test_a_missing_port_host_file_fails_loudly(tmp_path):
    path = TC.save_checkpoint(str(tmp_path), 1, (_placed(), {}, {}, {}),
                              per_host=True)
    os.remove(os.path.join(path, "shards.h0.npz"))
    os.remove(os.path.join(path, "shardidx.h0.pkl"))
    with pytest.raises(ValueError, match="does not cover leaf"):
        TC.restore_checkpoint(path)


def test_default_layout_writes_full_arrays(tmp_path):
    bundle = _placed()
    path = TC.save_checkpoint(str(tmp_path), 3, (bundle, {}, {}, {}))
    files = set(os.listdir(path))
    assert "leaves.npz" in files
    assert not any(f.startswith("shards.h") for f in files)
    for name in ("w", "b"):
        np.testing.assert_array_equal(TC.to_host_array(bundle[name]),
                                      bundle[name].gather().numpy())
    np.testing.assert_array_equal(TC.to_host_array(bundle["mu"]),
                                  _bits(bundle["mu"].gather()))
    (got, _, _, _), _ = TC.restore_checkpoint(path)
    assert torch.equal(got["w"], bundle["w"].gather())
    assert torch.equal(got["mu"], bundle["mu"].gather())


def _per_host(save):
    return lambda d, s, b, keep=3: save(d, s, b, keep=keep, per_host=True)


_JAX_RUN = {}


def _jax_run(tmp_path_factory):
    """The JAX estimator at dp 4 x mp 2 with ZeRO over 3 epochs, its
    checkpoints per host (once per module)."""
    if not _JAX_RUN:
        ckdir = str(tmp_path_factory.mktemp("jax_ck"))
        x, y = _tiny_data()
        orig = jest_mod.save_checkpoint
        jest_mod.save_checkpoint = _per_host(orig)
        try:
            est = JEstimator(JTinyTx(name="tiny"),
                             JO.SGD(lr=0.05, momentum=0.9), "mse",
                             ctx=_jctx(4, 2), shard_optimizer=True,
                             checkpoint_dir=ckdir)
            hist = est.train(JFeatureSet.from_ndarrays(x, y, shuffle=False),
                             batch_size=16, epochs=3,
                             variables=(_tiny_tree(), {}))
        finally:
            jest_mod.save_checkpoint = orig
        _JAX_RUN.update(ckdir=ckdir, losses=[h["loss"] for h in hist],
                        weights=_flat(est.params))
    return _JAX_RUN


def test_the_port_resumes_a_jax_per_host_checkpoint(tmp_path,
                                                    tmp_path_factory):
    ref = _jax_run(tmp_path_factory)
    ck = os.path.join(ref["ckdir"], "ckpt-8")
    assert os.path.exists(os.path.join(ck, "shards.h0.npz"))
    shutil.copytree(ck, str(tmp_path / "ckpt-8"))
    x, y = _tiny_data()
    net = TinyTx()
    est = Estimator(net, TO.SGD(lr=0.05, momentum=0.9), "mse",
                    ctx=_tctx(4, 2), shard_optimizer=True,
                    checkpoint_dir=str(tmp_path))
    hist = est.train(FeatureSet.from_ndarrays(x, y, shuffle=False),
                     batch_size=16, epochs=3, resume=True)
    assert est.global_step == 12 and len(hist) == 1
    np.testing.assert_allclose(hist[0]["loss"], ref["losses"][2],
                               rtol=1e-5, atol=1e-6)
    _same_weights(net, ref["weights"])


@pytest.mark.parametrize("dp,mp,kw", [
    (8, 1, {}), (2, 4, {}), (4, 2, {"shard_model": False})],
    ids=["dp8", "dp2mp4", "replicated"])
def test_reshape_restore_matrix(dp, mp, kw, tmp_path, tmp_path_factory,
                                monkeypatch):
    """A dp 4 x mp 2 ZeRO checkpoint the port wrote per host restores
    onto another mesh bit for bit and trains on to the JAX run."""
    ref = _jax_run(tmp_path_factory)
    ckdir = str(tmp_path / "ck")
    x, y = _tiny_data()
    fs = FeatureSet.from_ndarrays(x, y, shuffle=False)
    monkeypatch.setattr(test_mod, "save_checkpoint",
                        _per_host(test_mod.save_checkpoint))
    net = TinyTx()
    net.set_weights(_tiny_tree())
    first = Estimator(net, TO.SGD(lr=0.05, momentum=0.9), "mse",
                      ctx=_tctx(4, 2), shard_optimizer=True,
                      checkpoint_dir=ckdir)
    first.train(fs, batch_size=16, epochs=2)
    ck = TC.latest_checkpoint(ckdir)
    assert ck.endswith("ckpt-8")
    assert os.path.exists(os.path.join(ck, "shards.h0.npz"))
    (params, opt, _, _), _ = TC.restore_checkpoint(ck)
    for name, p in net.named_parameters():      # the write is exact
        assert torch.equal(params[name], p.detach()), name
    second = Estimator(TinyTx(), TO.SGD(lr=0.05, momentum=0.9), "mse",
                       ctx=_tctx(dp, mp), shard_optimizer=True,
                       checkpoint_dir=ckdir, **kw)
    second.train(fs, batch_size=16, epochs=2, resume=True)   # no new step
    assert second.global_step == 8
    for name, p in second.model.named_parameters():
        assert torch.equal(params[name], p.detach()), name
        assert torch.equal(second.params[name].gather(), p.detach()), name
    for name, t in second.opt_state["trace"].items():
        assert torch.equal(t.gather(), opt["trace"][name]), name
    if mp > 1 and second.shard_model:
        assert bytes_per_device(second.params) < tree_bytes(second.params)
    else:
        assert bytes_per_device(second.params) == tree_bytes(second.params)
    second.checkpoint_dir = None
    hist = second.train(fs, batch_size=16, epochs=1)
    assert second.global_step == 12
    np.testing.assert_allclose(hist[-1]["loss"], ref["losses"][2],
                               rtol=1e-5, atol=1e-6)
    _same_weights(second.model, ref["weights"], WEIGHT_TOL)


def test_a_bf16_moment_round_trips_through_the_estimator(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(test_mod, "save_checkpoint",
                        _per_host(test_mod.save_checkpoint))
    x, y = _tiny_data()
    net = TinyTx()
    net.set_weights(_tiny_tree())
    est = Estimator(net, TO.AdamWeightDecay(lr=0.01, total=8,
                                            state_dtype="bfloat16"),
                    "mse", ctx=_tctx(4, 2), shard_optimizer=True,
                    checkpoint_dir=str(tmp_path))
    est.train(FeatureSet.from_ndarrays(x, y, shuffle=False), batch_size=16,
              epochs=1)
    (_, opt, _, _), step = TC.restore_checkpoint(
        TC.latest_checkpoint(str(tmp_path)))
    assert step == 4
    assert int(opt["count"]) == int(opt["schedule_count"]) == 4
    for name, m in est.opt_state["mu"].items():
        assert opt["mu"][name].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(opt["mu"][name]),
                                      _bits(m.gather()))
