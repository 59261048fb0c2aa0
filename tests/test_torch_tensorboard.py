"""TensorBoard event files: the port's writer and reader against the JAX
package's.  The encoding is byte for byte the JAX one for the same event
and wall time; files each package writes decode with the other's reader
to the same records, apart from wall time; the Estimator writes the loss
and learning-rate curves at the same steps as the JAX Estimator (values:
the per-step losses' group means, 1e-5 relative, f32, dropout off)."""

import os

import jax
import numpy as np

from analytics_zoo_tpu.data import FeatureSet as JFeatureSet
from analytics_zoo_tpu.estimator import estimator as JE
from analytics_zoo_tpu.keras.optimizers import AdamWeightDecay as JAdamW
from analytics_zoo_tpu.tensorboard import events as JEv
from analytics_zoo_tpu.tensorboard import writer as JW
from analytics_zoo_tpu.tfpark.text_estimators import BERTClassifier as JBERT
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.estimator import estimator as TE
from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay as TAdamW
from analytics_zoo_tpu_torch.tensorboard import events as TEv
from analytics_zoo_tpu_torch.tensorboard import writer as TW
from analytics_zoo_tpu_torch.tfpark import BERTClassifier as TBERT


def test_encoding_is_byte_for_byte_the_jax_one():
    for data in (b"", b"123456789", bytes(range(256))):
        assert TEv.crc32c(data) == JEv.crc32c(data)
        assert TEv.masked_crc32c(data) == JEv.masked_crc32c(data)
    for tag, value, step in (("Loss", 0.25, 3), ("a/b", -1e-7, 2**40),
                             ("Throughput", 1234.5, 0)):
        t = TEv.encode_event(TEv.encode_scalar_summary(tag, value), step,
                             wall_time=1.5e9)
        j = JEv.encode_event(JEv.encode_scalar_summary(tag, value), step,
                             wall_time=1.5e9)
        assert t == j and TEv.frame_record(t) == JEv.frame_record(j)
    vals = np.random.default_rng(0).standard_normal(100)
    assert TEv.encode_histogram_summary("h", vals) == \
        JEv.encode_histogram_summary("h", vals)
    assert TEv.encode_event(file_version="brain.Event:2", wall_time=1.0) \
        == JEv.encode_event(file_version="brain.Event:2", wall_time=1.0)


def _scalars(W, log_dir):
    with W.TrainSummary(log_dir, "app") as tb:
        for step in range(1, 6):
            tb.record_step(step, 1.0 / step, 100.0 * step, 1e-3 * step)
    with W.ValidationSummary(log_dir, "app") as vs:
        vs.record_metric(5, "accuracy", 0.75)
    return os.path.join(log_dir, "app", "train"), \
        os.path.join(log_dir, "app", "validation")


def _records(Ev, directory):
    out = []
    for fname in sorted(os.listdir(directory)):
        out.extend((step, tag, value) for _, step, tag, value in
                   Ev.decode_scalar_events(os.path.join(directory, fname)))
    return out


def test_files_decode_alike_in_both_packages(tmp_path):
    ttrain, tval = _scalars(TW, str(tmp_path / "t"))
    jtrain, jval = _scalars(JW, str(tmp_path / "j"))
    for t, j in ((ttrain, jtrain), (tval, jval)):
        want = _records(JEv, j)
        assert want and _records(TEv, t) == want
        assert _records(JEv, t) == _records(TEv, j) == want
    for tag in ("Loss", "Throughput", "LearningRate"):
        got, ref = TW.read_scalar(ttrain, tag), JW.read_scalar(jtrain, tag)
        assert got.shape == ref.shape == (5, 3)
        np.testing.assert_array_equal(got[:, :2], ref[:, :2])
    assert TW.read_scalar(str(tmp_path / "none"), "Loss").shape == (0, 3)


def test_a_torn_last_record_is_tolerated(tmp_path):
    ttrain, _ = _scalars(TW, str(tmp_path))
    path = os.path.join(ttrain, os.listdir(ttrain)[0])
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        fh.write(data[:-5])
    assert len(TW.read_scalar(ttrain, "LearningRate")) == 4


def test_estimator_writes_the_jax_curves(tmp_path):
    cfg = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=16,
               intermediate_size=64, hidden_drop=0.0, attn_drop=0.0)
    opt = dict(lr=1e-3, warmup_portion=0.2, total=40, weight_decay=0.01)
    jclf = JBERT(num_classes=2, bert_config=cfg)
    params, _ = jclf.net.build(jax.random.PRNGKey(3))
    start = jax.tree_util.tree_map(np.array, params)
    tclf = TBERT(num_classes=2, bert_config=cfg, device="cpu")
    tclf.load_weights(start)
    rs = np.random.default_rng(0)
    ids = rs.integers(1, 50, (48, 16)).astype(np.int32)
    x, y = [ids, np.zeros_like(ids), np.ones_like(ids)], ids[:, 0] % 2
    for K in (1, 4):
        jest = JE.Estimator(jclf.net, JAdamW(**opt),
                            "sparse_categorical_crossentropy",
                            steps_per_dispatch=K,
                            tensorboard_dir=str(tmp_path / f"j{K}"),
                            app_name="bert")
        test = TE.Estimator(tclf.net, TAdamW(**opt),
                            "sparse_categorical_crossentropy",
                            steps_per_dispatch=K,
                            tensorboard_dir=str(tmp_path / f"t{K}"),
                            app_name="bert", device="cpu")
        # 6 steps an epoch: K = 4 gives a group and two single steps
        jest.train(JFeatureSet.from_ndarrays(list(x), y).cache_device(),
                   batch_size=8, epochs=2, variables=(start, {}))
        tclf.load_weights(start)
        test.train(FeatureSet.from_ndarrays(list(x), y).cache_device(),
                   batch_size=8, epochs=2)
        jdir = str(tmp_path / f"j{K}" / "bert" / "train")
        tdir = str(tmp_path / f"t{K}" / "bert" / "train")
        for tag, rtol in (("Loss", 1e-5), ("LearningRate", 1e-6)):
            got, want = TW.read_scalar(tdir, tag), JW.read_scalar(jdir, tag)
            steps = [1, 2, 3, 4, 5, 6] if K == 1 else [4, 5, 6]
            assert got[:, 0].tolist() == want[:, 0].tolist() == \
                steps + [s + 6 for s in steps]
            np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=rtol)
        tp = TW.read_scalar(tdir, "Throughput")
        assert len(tp) == len(steps) * 2 and (tp[:, 1] > 0).all()
