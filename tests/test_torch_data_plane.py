"""The sharded ingest path of the port against the JAX package, on the CPU.

The same ``.npz`` and TFRecord shards, seeds and windows go through the
JAX ``ShardedFeatureSet`` and the port's: the batches (``local_batches``,
and ``batches`` from every ``start_step``) must be equal, element for
element.  ``Transforms`` interpret a chain to the JAX package's result
(1e-6: both are f32 arithmetic in one order).  A tiny NeuralCF and a tiny
BERT classifier trained from shards follow the JAX trajectories to 1e-5
(f32, dropout off: XLA's and PyTorch's CPU kernels sum in other orders)
and the port's in-memory path bit for bit.  A mid-epoch resume, and a
retry after a fault at ``shard_read`` or ``transform_apply``, end on the
uninterrupted run's weights bit for bit with no ``zoo-data-*`` thread left.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data import FeatureSet as JFeatureSet
from analytics_zoo_tpu.data import ShardedFeatureSet as JSharded
from analytics_zoo_tpu.data import Transforms as JTransforms
from analytics_zoo_tpu.data import build_manifest as jbuild_manifest
from analytics_zoo_tpu.estimator import estimator as JE
from analytics_zoo_tpu.keras import engine as jengine
from analytics_zoo_tpu.models import recommendation as JR
from analytics_zoo_tpu_torch.common.triggers import (MaxIteration,
                                                     SeveralIteration)
from analytics_zoo_tpu_torch.data import (
    DataCursor, FeatureSet, ShardedFeatureSet, Transforms, assign_shards,
    build_manifest, write_npz_shards)
from analytics_zoo_tpu_torch.data.tfrecord import build_example, \
    write_records
from analytics_zoo_tpu_torch.estimator import estimator as TE
from analytics_zoo_tpu_torch.estimator.checkpoint import (
    latest_checkpoint, restore_checkpoint)
from analytics_zoo_tpu_torch.keras import engine as tengine
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras.engine import Sequential
from analytics_zoo_tpu_torch.models import recommendation as TR
from analytics_zoo_tpu_torch.testing import chaos

LOSS = "sparse_categorical_crossentropy"
NCF = dict(user_count=100, item_count=80, class_num=2, user_embed=8,
           item_embed=8, hidden_layers=(16, 8), mf_embed=8)


def _linear(n=256, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    return x, (x @ rs.randn(8, 1)).astype(np.float32)


def _npz(tmp, n=256, shards=8):
    x, y = _linear(n)
    return x, y, write_npz_shards(str(tmp), x, y, shards)


def _tfrecords(tmp, n=120, shards=5, seed=0):
    rs = np.random.RandomState(seed)
    paths = []
    for s in range(shards):
        recs = [build_example({"user": np.array([rs.randint(1, 101)]),
                               "item": np.array([rs.randint(1, 81)]),
                               "label": np.array([rs.randint(0, 2)])})
                for _ in range(n // shards)]
        p = str(tmp / f"part_{s:02d}.tfrecord")
        write_records(p, recs)
        paths.append(p)
    return paths


def _as_np(tree):
    return jax.tree_util.tree_map(
        lambda a: a.numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a), tree)


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        gl, gd = jax.tree_util.tree_flatten(_as_np(g))
        wl, wd = jax.tree_util.tree_flatten(_as_np(w))
        assert gd == wd
        for a, b in zip(gl, wl):
            # the JAX set's device batches hold int64 columns as int32
            # (jax without x64); the port keeps them
            assert jax.dtypes.canonicalize_dtype(a.dtype) == \
                jax.dtypes.canonicalize_dtype(b.dtype)
            np.testing.assert_array_equal(a, b)


def _no_data_threads():
    return not [t for t in threading.enumerate()
                if t.name.startswith("zoo-data")]


# --- manifest, assignment, batches ------------------------------------------

def test_manifest_and_assignment_match_jax(tmp_path):
    _, _, npz = _npz(tmp_path / "npz", n=250)
    tfr = _tfrecords(tmp_path)
    for paths in (npz, tfr, [str(tmp_path / "npz")]):
        got = [(s.path, s.kind, s.size) for s in build_manifest(paths)]
        want = [(s.path, s.kind, s.size) for s in jbuild_manifest(paths)]
        assert got == want
    from analytics_zoo_tpu.data import assign_shards as jassign
    for pc in (1, 3, 8):
        for pi in range(pc):
            assert assign_shards(11, pi, pc) == jassign(11, pi, pc)
    with pytest.raises(ValueError):
        assign_shards(4, 2, 2)


@pytest.mark.parametrize("shuffle,window,seed", [
    (True, 2, 3), (True, 3, 9), (False, 2, 0), (True, 1, 5)])
def test_batches_equal_jax_from_every_start_step(shuffle, window, seed, ctx,
                                                 tmp_path):
    _, _, paths = _npz(tmp_path, n=250)           # ragged shards and tail
    kw = dict(shuffle=shuffle, seed=seed, window_shards=window)
    t, j = ShardedFeatureSet(paths, **kw), JSharded(paths, **kw)
    assert t.steps_per_epoch(32) == j.steps_per_epoch(32) == 7
    assert t.steps_per_epoch(32, False) == j.steps_per_epoch(32, False)
    for epoch in (0, 1):
        _assert_same_batches(t.local_batches(32, epoch),
                             j.local_batches(32, epoch))
        _assert_same_batches(
            t.local_batches(32, epoch, drop_remainder=False),
            j.local_batches(32, epoch, drop_remainder=False))
        for k in (0, 1, 4, 6):
            _assert_same_batches(
                t.batches(32, epoch, start_step=k),
                j.batches(32, epoch, ctx=ctx, start_step=k))


def test_tfrecord_batches_and_eager_chain_equal_jax(ctx, tmp_path):
    paths = _tfrecords(tmp_path)
    mk = lambda T: (T(fuse=False).cast("int32", field="user")
                    .one_hot(4, field="item"))
    kw = dict(feature_keys=["user", "item"], label_keys=["label"],
              shuffle=True, seed=2, window_shards=2)
    t = ShardedFeatureSet(paths, transforms=mk(Transforms), **kw)
    j = JSharded(paths, transforms=mk(JTransforms), **kw)
    assert t.labels is j.labels is True
    _assert_same_batches(t.batches(16, 1, start_step=2),
                         j.batches(16, 1, ctx=ctx, start_step=2))
    _assert_same_batches(t.local_batches(16, 0, drop_remainder=False),
                         j.local_batches(16, 0, drop_remainder=False))


def test_staging_replays_and_evict_redecodes(tmp_path):
    from analytics_zoo_tpu_torch import observability as obs
    _, _, paths = _npz(tmp_path)
    reads = lambda src: obs.get_registry().snapshot().get(
        "zoo_data_shards_read_total", {}).get("series", {}).get(
        (("source", src),), 0.0)
    fs = ShardedFeatureSet(paths, shuffle=True, seed=1)
    d0, s0 = reads("decode"), reads("stage")
    list(fs.batches(32, 0))
    # the probe staged shard 0: epoch 0 decodes the other 7
    assert (reads("decode") - d0, reads("stage") - s0) == (7, 1)
    list(fs.batches(32, 1))
    assert (reads("decode") - d0, reads("stage") - s0) == (7, 9)
    fs.evict()
    list(fs.batches(32, 2))
    assert reads("decode") - d0 == 15
    nostage = ShardedFeatureSet(paths, seed=1, stage_cache=False)
    _assert_same_batches(nostage.local_batches(32, 3),
                         fs.local_batches(32, 3))


def test_abandoned_pipeline_strands_nothing(tmp_path):
    _, _, paths = _npz(tmp_path)
    for depth in (0, 2):
        fs = ShardedFeatureSet(paths, prefetch=depth)
        it = fs.batches(32, 0)
        x, y = next(it)
        assert isinstance(x, torch.Tensor) and x.shape == (32, 8)
        it.close()
        assert _no_data_threads()


# --- transforms -------------------------------------------------------------

def _chains():
    def both(build):
        return build(Transforms), build(JTransforms)
    return {
        "normalize_cast_map": both(lambda T: T().normalize([1.0], [2.0])
                                   .cast("float32")
                                   .map(lambda a: a * 2.0 - 1.0,
                                        tag="rescale")),
        "one_hot_field": both(lambda T: T().one_hot(5, field="c")),
        "crop": both(lambda T: T().crop(1, 2, 3, 4)),
        "cast_index": both(lambda T: T(fuse=False).cast("int32", field=1)),
    }


def _chain_input(name):
    rs = np.random.RandomState(0)
    if name == "one_hot_field":
        return {"c": np.array([0, 2, 4, 7, -1]), "d": np.ones(5, np.float32)}
    if name == "crop":
        return rs.randn(2, 8, 8, 3).astype(np.float32)
    if name == "cast_index":
        return (rs.randn(4, 2).astype(np.float32),
                np.arange(4, dtype=np.int64))
    return rs.randn(16, 4).astype(np.float32)


@pytest.mark.parametrize("name", list(_chains()))
def test_transforms_equal_jax(name):
    t, j = _chains()[name]
    assert t.signature == j.signature and len(t) == len(j)
    x = _chain_input(name)
    want = _as_np(j.apply_host(x))
    want_jit = _as_np(j.apply_jax(x))
    xt = jax.tree_util.tree_map(torch.from_numpy, x)
    for got in (_as_np(t.apply_host(x)), _as_np(t.apply_jax(xt))):
        gl, gd = jax.tree_util.tree_flatten(got)
        for w in (want, want_jit):
            wl, wd = jax.tree_util.tree_flatten(w)
            assert gd == wd
            for a, b in zip(gl, wl):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


# --- training from shards ---------------------------------------------------

def _ncf_pair():
    jengine.reset_uids()
    jm = JR.NeuralCF(**NCF)
    params, state = jm.init(jax.random.PRNGKey(0))
    tengine.reset_uids()
    tm = TR.NeuralCF(device="cpu", **NCF)
    tree = (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))
    tm.set_weights(tree)
    return jm, tm, tree


def _ncf_data(tmp, n=256):
    rs = np.random.RandomState(0)
    u = rs.randint(1, 101, (n, 1)).astype(np.int32)
    i = rs.randint(1, 81, (n, 1)).astype(np.int32)
    lbl = rs.randint(0, 2, (n,)).astype(np.int32)
    return (u, i), lbl, write_npz_shards(str(tmp), (u, i), lbl, 8)


def _weights(net):
    return jax.tree_util.tree_leaves(_as_np(net.get_weights()[0]))


@pytest.mark.parametrize("spd", [1, 4])
def test_ncf_from_shards_matches_jax_and_in_memory(spd, tmp_path):
    x, y, paths = _ncf_data(tmp_path)
    jm, tm, tree = _ncf_pair()
    kw = dict(shuffle=True, seed=4, window_shards=2)
    jest = JE.Estimator(jm, "adam", LOSS, steps_per_dispatch=spd)
    jest.train(JSharded(paths, **kw), batch_size=32, epochs=2,
               variables=tree)
    test = TE.Estimator(tm, "adam", LOSS, steps_per_dispatch=spd,
                        device="cpu")
    test.train(ShardedFeatureSet(paths, **kw), batch_size=32, epochs=2)
    want = jax.tree_util.tree_leaves(_as_np(jest.params))
    got = _weights(tm)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    # the same records in the same order through the in-memory tier: the
    # port's two paths agree bit for bit
    _, mem, _ = _ncf_pair()
    TE.Estimator(mem, "adam", LOSS, steps_per_dispatch=spd,
                 device="cpu").train(
        FeatureSet.from_ndarrays(x, y, shuffle=False), batch_size=32,
        epochs=2)
    _, sh, _ = _ncf_pair()
    TE.Estimator(sh, "adam", LOSS, steps_per_dispatch=spd,
                 device="cpu").train(
        ShardedFeatureSet(paths, shuffle=False), batch_size=32, epochs=2)
    for a, b in zip(_weights(mem), _weights(sh)):
        np.testing.assert_array_equal(a, b)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_bert_from_shards_matches_jax_and_in_memory(tmp_path):
    from analytics_zoo_tpu.tfpark.text_estimators import (
        BERTClassifier as JBERT)
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier as TBERT
    hidden = 16
    cfg = dict(vocab=50, hidden_size=hidden, n_block=1, n_head=2,
               seq_len=8, intermediate_size=32, hidden_drop=0.0,
               attn_drop=0.0)
    rs = np.random.RandomState(1)
    n = 64
    ids = rs.randint(1, 50, (n, 8)).astype(np.int32)
    seg = np.zeros((n, 8), np.int32)
    mask = np.ones((n, 8), np.int32)
    lbl = (ids[:, 0] % 2).astype(np.int32)
    paths = write_npz_shards(str(tmp_path), (ids, seg, mask), lbl, 4)
    jclf = JBERT(num_classes=2, bert_config=cfg)
    params, _ = jclf.net.build(jax.random.PRNGKey(3))
    start = jax.tree_util.tree_map(np.array, params)

    def port(fs):
        clf = TBERT(num_classes=2, bert_config=cfg, device="cpu")
        clf.load_weights(start)
        TE.Estimator(clf.net, "adam", LOSS, device="cpu").train(
            fs, batch_size=16, epochs=2)
        return _flat(_as_np(clf.net.get_weights()[0]))

    jest = JE.Estimator(jclf.net, "adam", LOSS)
    jest.train(JSharded(paths, shuffle=True, seed=2), batch_size=16,
               epochs=2, variables=(start, {}))
    got = port(ShardedFeatureSet(paths, shuffle=True, seed=2))
    want = _flat(_as_np(jest.params))
    assert set(got) == set(want)
    for name, w in want.items():
        keep = np.ones(w.shape, bool)
        if name.endswith("attn.qkv.b"):
            # the key bias: its true gradient is 0 (softmax ignores a
            # constant added to a row's scores), so Adam steps on rounding
            # noise in either package
            keep[hidden:2 * hidden] = False
        np.testing.assert_allclose(got[name][keep], w[keep], atol=1e-5,
                                   rtol=0, err_msg=name)
    mem = port(FeatureSet.from_ndarrays((ids, seg, mask), lbl,
                                        shuffle=False))
    sh = port(ShardedFeatureSet(paths, shuffle=False))
    for name in mem:
        np.testing.assert_array_equal(mem[name], sh[name], err_msg=name)


def _dense_net():
    tengine.reset_uids()
    net = Sequential([L.Dense(16, activation="tanh", input_shape=(8,),
                              name="d1"),
                      L.Dense(1, name="d2")], device="cpu")
    torch.manual_seed(0)
    for p in net.parameters():
        torch.nn.init.normal_(p, std=0.3)
    return net


def _train_dense(paths, ckdir=None, inj=None, end=None, transforms=None,
                 spd=1, resume=False, seen=None):
    fs = ShardedFeatureSet(paths, shuffle=True, seed=7,
                           transforms=transforms)
    net = _dense_net()
    est = TE.Estimator(net, "adam", "mse", checkpoint_dir=ckdir,
                       checkpoint_trigger=SeveralIteration(4),
                       steps_per_dispatch=spd, device="cpu")
    if seen is not None:
        orig = est._step_from

        def spy(src):
            seen.append(src.xs[int(est._cursor)][:, 0].clone())
            return orig(src)
        est._step_from = spy
    kw = {} if end is None else {"end_trigger": MaxIteration(end)}
    with chaos.installed(inj or chaos.ChaosInjector()):
        est.train(fs, batch_size=32, epochs=2, resume=resume, **kw)
    return est, _weights(net)


@pytest.mark.parametrize("spd", [1, 4])
def test_mid_epoch_resume_is_sample_exact(spd, tmp_path):
    x, _, paths = _npz(tmp_path / "shards")
    seen_clean = []
    clean_est, clean = _train_dense(paths, spd=spd, seen=seen_clean)
    assert clean_est.global_step == 16
    ck = str(tmp_path / "ck")
    seen = []
    _, _ = _train_dense(paths, ckdir=ck, end=12, spd=spd, seen=seen)
    (_, _, _, meta), step = restore_checkpoint(latest_checkpoint(ck))
    assert step == 12 and meta["data_cursor"] == {"epoch": 1, "step": 4}
    assert DataCursor.from_state(meta["data_cursor"]) == DataCursor(1, 4)
    est, got = _train_dense(paths, ckdir=ck, spd=spd, resume=True,
                            seen=seen)
    assert est.global_step == 16
    for a, b in zip(got, clean):
        np.testing.assert_array_equal(a, b)
    # every record once an epoch, before and after the restart
    rows = [torch.cat(seen[e * 8:(e + 1) * 8]).numpy() for e in (0, 1)]
    for e, r in enumerate(rows):
        np.testing.assert_array_equal(np.sort(r), np.sort(x[:, 0]))
        np.testing.assert_array_equal(
            r, torch.cat(seen_clean[e * 8:(e + 1) * 8]).numpy())


@pytest.mark.parametrize("point,at,fuse", [
    ("shard_read", 13, True), ("transform_apply", 10, False)])
def test_fault_retried_from_checkpoint_ends_on_clean_weights(point, at, fuse,
                                                            tmp_path):
    _, _, paths = _npz(tmp_path / "shards")
    mk = lambda: Transforms(fuse=fuse).normalize(0.5, 2.0)
    _, clean = _train_dense(paths, ckdir=str(tmp_path / "a"),
                            transforms=mk())
    inj = chaos.ChaosInjector()
    inj.plan(point, fault="raise", at=[at])
    est, got = _train_dense(paths, ckdir=str(tmp_path / "b"), inj=inj,
                            transforms=mk())
    assert inj.injected(point) == 1
    assert est.global_step == 16
    for a, b in zip(got, clean):
        np.testing.assert_array_equal(a, b)
    assert _no_data_threads()


def test_fused_and_eager_chains_train_equal_and_rekey(tmp_path):
    _, _, paths = _npz(tmp_path)
    runs = []
    for fuse in (True, False):
        tf = (Transforms(fuse=fuse).normalize(0.5, 2.0)
              .map(lambda a: a * 1.5, tag="s"))
        est, w = _train_dense(paths, transforms=tf)
        assert (est._fused_tf is tf) == fuse
        runs.append(w)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    # a new chain replaces the adopted one (its signature keys the step)
    net = _dense_net()
    est = TE.Estimator(net, "adam", "mse", device="cpu")
    tfs = [Transforms().normalize(0.0, s) for s in (1.0, 2.0)]
    for tf in tfs:
        est.train(ShardedFeatureSet(paths, shuffle=False, transforms=tf),
                  batch_size=32, epochs=1)
        assert est._fused_tf is tf
    assert tfs[0].signature != tfs[1].signature
    # evaluate / predict run the fused chain too
    fs = ShardedFeatureSet(paths, shuffle=False, transforms=tfs[1])
    x = np.concatenate([b[0] for b in fs.local_batches(32, ordered=True)])
    with torch.no_grad():
        want = net(torch.from_numpy(x / 2.0)).numpy()
    np.testing.assert_allclose(est.predict(fs, batch_size=48), want,
                               atol=1e-6)
