"""The port's FeatureSet tiers and factories against the JAX package's.

The generator tier (the seeded window shuffle, bare features, a ragged
tail), the disk tier (slice files written by either package read by the
other, ``f{j}`` / ``l{j}`` in ``jax.tree_util`` leaf order, dict and
tuple trees), the DEVICE tier over a streamed base, ``from_sources`` for
every memory type, ``from_dataframe`` (duck-typed) and the TFDataset
factories: the same batches in the same order as JAX for the same seed,
and the Estimator trains from each tier as from the in-memory one.
"""

import jax
import numpy as np
import pytest

from analytics_zoo_tpu.data import featureset as JF
from analytics_zoo_tpu.tfpark import TFDataset as JTFDataset
from analytics_zoo_tpu_torch.data import featureset as TF
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.keras import engine
from analytics_zoo_tpu_torch.keras.layers import Dense
from analytics_zoo_tpu_torch.tfpark import TFDataset


@pytest.fixture(autouse=True)
def _fresh_port_context():
    """The port's context is process-wide, as the JAX package's is: each
    test starts and ends without one."""
    from analytics_zoo_tpu_torch.common.context import reset_context
    reset_context()
    yield
    reset_context()


def _rows(n=37, seed=0):
    rs = np.random.RandomState(seed)
    feats = {"b": rs.randn(n, 3).astype(np.float32),
             "a": rs.randint(0, 9, (n, 2)).astype(np.int32)}
    labels = (rs.randn(n) > 0).astype(np.int32)
    return feats, labels


def _gen_factory(feats, labels, with_labels=True):
    n = len(labels)

    def gen():
        for i in range(n):
            x = {k: v[i] for k, v in feats.items()}
            yield (x, labels[i]) if with_labels else x
    return gen


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert (gy is None) == (wy is None)
        g_leaves = jax.tree_util.tree_leaves((gx, gy))
        w_leaves = jax.tree_util.tree_leaves((wx, wy))
        assert len(g_leaves) == len(w_leaves)
        for g, w in zip(g_leaves, w_leaves):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_tree_flatten_is_jax_order_and_round_trips():
    tree = {"z": [np.zeros(1), (np.ones(2), np.full(3, 2.0))],
            "a": {"y": np.arange(4), "b": np.arange(5)}}
    leaves, treedef = TF.tree_flatten(tree)
    want = jax.tree_util.tree_leaves(tree)
    assert [a.shape for a in leaves] == [a.shape for a in want]
    back = TF.tree_unflatten(treedef, leaves)
    assert list(back) == ["a", "z"] and isinstance(back["z"][1], tuple)
    assert TF.tree_flatten(np.ones(2))[1] is None


@pytest.mark.parametrize("shuffle,window", [(False, None), (True, None),
                                            (True, 5)])
@pytest.mark.parametrize("epoch", [0, 3])
def test_generator_tier_gives_jax_batches(shuffle, window, epoch):
    feats, labels = _rows()
    kw = dict(shuffle=shuffle, seed=11, shuffle_window=window)
    port = TF.FeatureSet.from_generator(_gen_factory(feats, labels), 33, **kw)
    ref = JF.FeatureSet.from_generator(_gen_factory(feats, labels), 33, **kw)
    assert len(port) == port.size() == 33
    assert port.steps_per_epoch(4) == ref.steps_per_epoch(4) == 8
    for drop in (True, False):
        _same_batches(port.local_batches(4, epoch, drop),
                      ref.local_batches(4, epoch, drop))
    _same_batches(port.local_batches(4, epoch, ordered=True),
                  ref.local_batches(4, epoch, ordered=True))


def test_generator_tier_without_labels_and_device_batches():
    feats, labels = _rows(12)
    port = TF.GeneratorFeatureSet(_gen_factory(feats, labels, False), 12)
    ref = JF.GeneratorFeatureSet(_gen_factory(feats, labels, False), 12)
    _same_batches(port.local_batches(5, drop_remainder=False),
                  ref.local_batches(5, drop_remainder=False))
    xs = [x for x, _ in port.batches(4, device="cpu")]
    assert len(xs) == 3 and xs[0]["a"].dtype.is_floating_point is False
    rows = [n for _, _, n in port.batches_with_counts(
        5, drop_remainder=False, device="cpu")]
    assert rows == [5, 5, 2]


@pytest.mark.parametrize("labelled", [True, False])
def test_disk_slices_cross_read_both_ways(tmp_path, labelled):
    feats, labels = _rows(29)
    y = labels if labelled else None
    port = TF.FeatureSet(feats, y, seed=5).to_disk(str(tmp_path / "t"), 4)
    ref = JF.FeatureSet(feats, y, seed=5).to_disk(str(tmp_path / "j"), 4)
    assert port.num_slices == ref.num_slices == 4
    for pt, pj in zip(port.paths, ref.paths):
        with np.load(pt) as zt, np.load(pj) as zj:
            assert sorted(zt.files) == sorted(zj.files)
            for k in zj.files:
                np.testing.assert_array_equal(zt[k], zj[k])
    # each package reads the other's slices, with its own tree structure
    cross_t = TF.DiskFeatureSet(ref.paths, feat_def=port.feat_def,
                                label_def=port.label_def, seed=5)
    cross_j = JF.DiskFeatureSet(port.paths, feat_def=ref.feat_def,
                                label_def=ref.label_def, seed=5)
    for epoch in (0, 1):
        want = list(ref.local_batches(4, epoch))
        _same_batches(port.local_batches(4, epoch), want)
        _same_batches(cross_t.local_batches(4, epoch), want)
        _same_batches(cross_j.local_batches(4, epoch), want)
    _same_batches(port.local_batches(4, 0, False, ordered=True),
                  ref.local_batches(4, 0, False, ordered=True))
    assert port.steps_per_epoch(4) == ref.steps_per_epoch(4)
    assert (port.labels is None) == (not labelled)
    # without a structure: one leaf is an array, several a tuple
    bare_t = TF.DiskFeatureSet(ref.paths, shuffle=False)
    bare_j = JF.DiskFeatureSet(ref.paths, shuffle=False)
    _same_batches(bare_t.local_batches(8), bare_j.local_batches(8))
    with pytest.raises(ValueError, match="no slice files"):
        TF.DiskFeatureSet([])


def test_from_sources_every_memory_type(tmp_path):
    feats, labels = _rows(20)
    for mt in ("DRAM", "DIRECT", "PMEM", "dram"):
        fs = TF.FeatureSet.from_sources(feats, labels, memory_type=mt)
        assert type(fs) is TF.FeatureSet and len(fs) == 20
    for mt in ("DEVICE", "HBM"):
        assert isinstance(TF.FeatureSet.from_sources(
            feats, labels, memory_type=mt), TF.DeviceFeatureSet)
    for mt, n in (("DISK_AND_DRAM", 4), ("DISK_AND_DRAM:3", 3)):
        fs = TF.FeatureSet.from_sources(feats, labels, memory_type=mt,
                                        cache_dir=str(tmp_path / mt[-1]),
                                        seed=2)
        ref = JF.FeatureSet.from_sources(feats, labels, memory_type=mt,
                                         cache_dir=str(tmp_path / "j"),
                                         seed=2)
        assert isinstance(fs, TF.DiskFeatureSet) and fs.num_slices == n
        _same_batches(fs.local_batches(3, 1), ref.local_batches(3, 1))


class _Column:
    def __init__(self, values):
        self.values = np.asarray(values)

    def to_numpy(self):
        return self.values


class _Frame:
    """A pandas-like frame: ``df[col].to_numpy()``."""

    def __init__(self, cols):
        self.cols = cols

    def __getitem__(self, name):
        return _Column(self.cols[name])


class _SparkFrame:
    def __init__(self, frame):
        self.frame = frame

    def toPandas(self):
        return self.frame


def test_from_dataframe_matches_jax():
    rs = np.random.RandomState(4)
    df = _Frame({"u": rs.randint(0, 9, 10), "i": rs.randint(0, 5, 10),
                 "r": rs.rand(10).astype(np.float32)})
    for frame in (df, _SparkFrame(df)):
        for cols, lab in ((["u", "i"], ["r"]), (["u"], None),
                          (["u"], ["r", "i"])):
            got = TF.FeatureSet.from_dataframe(frame, cols, lab,
                                               shuffle=False)
            want = JF.FeatureSet.from_dataframe(frame, cols, lab,
                                                shuffle=False)
            _same_batches(got.local_batches(5), want.local_batches(5))
    one = TF.FeatureSet.from_dataframe(df, ["u"], ["r"])
    assert one.features.shape == (10, 1) and one.labels.shape == (10,)
    ds = TFDataset.from_dataframe(df, ["u", "i"], ["r"], batch_size=5,
                                  val_df=df)
    jds = JTFDataset.from_dataframe(df, ["u", "i"], ["r"], batch_size=8)
    assert ds.has_labels == jds.has_labels and len(ds) == len(jds) == 10
    assert len(ds.get_validation_data()) == 10
    assert not TFDataset.from_dataframe(df, ["u"], batch_size=5).has_labels


def test_tfdataset_generator_and_feature_set_factories():
    feats, labels = _rows(16)
    ds = TFDataset.from_generator(_gen_factory(feats, labels), 16,
                                  batch_size=4)
    assert isinstance(ds.get_training_data(), TF.GeneratorFeatureSet)
    assert ds.effective_batch_size == 4 and len(ds) == 16
    fs = TF.FeatureSet(feats, labels)
    val = TF.FeatureSet(feats, labels)
    ds = TFDataset.from_feature_set(fs, batch_per_thread=3,
                                    validation_dataset=val)
    assert ds.get_training_data() is fs and ds.get_validation_data() is val
    assert ds.effective_batch_size == 3
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        TFDataset.from_rdd([1, 2])


def test_device_tier_over_a_generator_replays_jax_order():
    """The DEVICE tier's composition and per-epoch batch order over a
    streamed base: the JAX tier's cached batch list and its ``batches``
    stream (batch 8 divides the 8-device CPU mesh)."""
    from analytics_zoo_tpu.common.context import init_zoo_context
    init_zoo_context()
    feats, labels = _rows(40)
    kw = dict(shuffle=True, seed=3, shuffle_window=6)
    port = TF.GeneratorFeatureSet(_gen_factory(feats, labels), 40,
                                  **kw).cache_device()
    ref = JF.GeneratorFeatureSet(_gen_factory(feats, labels), 40,
                                 **kw).cache_device()
    for epoch in (0, 2):
        got = [(jax.tree_util.tree_map(lambda t: t.numpy(), x), y.numpy())
               for x, y in port.batches(8, epoch, device="cpu")]
        want = [(x, y) for x, y in ref.batches(8, epoch)]
        _same_batches(got, want)
    xs, ys, steps, perm = port.stacked_epoch(8, 2, device="cpu")
    assert steps == 5 and tuple(ys.shape) == (5, 8)
    assert tuple(xs["b"].shape) == (5, 8, 3)


def _net():
    engine.reset_uids()
    net = engine.Sequential([Dense(4, activation="tanh", input_shape=(3,)),
                             Dense(2, activation="softmax")], device="cpu")
    net.init(generator=__import__("torch").Generator().manual_seed(0))
    return net


def test_estimator_trains_from_every_tier_as_from_memory(tmp_path):
    feats, labels = _rows(24)
    x = feats["b"]
    gen = lambda: ((x[i], labels[i]) for i in range(24))
    tiers = {
        "memory": TF.FeatureSet(x, labels, shuffle=False),
        "generator": TF.GeneratorFeatureSet(gen, 24),
        "disk": TF.FeatureSet(x, labels, shuffle=False).to_disk(
            str(tmp_path), 2),
        "device over generator": TF.GeneratorFeatureSet(
            gen, 24).cache_device(),
    }
    hists = {}
    for name, fs in tiers.items():
        est = Estimator(_net(), "sgd", "sparse_categorical_crossentropy",
                        device="cpu")
        hists[name] = [h["loss"] for h in est.train(fs, 4, epochs=2)]
    for name, h in hists.items():
        np.testing.assert_allclose(h, hists["memory"], rtol=1e-6,
                                   err_msg=name)
