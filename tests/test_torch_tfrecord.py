"""The port's TFRecord codec against the JAX package's, on the CPU.

Files the port writes are byte-identical to the JAX writer's from the same
examples, and each package reads the other's files to the same arrays;
the framing's masked CRC32C (the table loop), corrupt and truncated
records, unpacked wire encodings, bytes / float / int64 features with
negative ints, a directory of shards, ragged features, and the SQuAD
feature names of Google BERT's ``run_squad.py`` feeding
``FeatureSet`` / ``TFDataset.from_tfrecord_file``.
"""

import numpy as np
import pytest

from analytics_zoo_tpu.data import tfrecord as jtfr
from analytics_zoo_tpu.data.featureset import FeatureSet as JFeatureSet
from analytics_zoo_tpu_torch.data import tfrecord as ttfr
from analytics_zoo_tpu_torch.data.featureset import FeatureSet
from analytics_zoo_tpu_torch.tfpark import TFDataset

SQUAD_KEYS = ("unique_ids", "input_ids", "input_mask", "segment_ids",
              "start_positions", "end_positions")


def _examples(n=6, T=12, seed=0):
    """``run_squad.py``-style int64 features, plus a float and a bytes
    feature."""
    rs = np.random.default_rng(seed)
    out = []
    for i in range(n):
        valid = int(rs.integers(3, T + 1))
        mask = (np.arange(T) < valid).astype(np.int64)
        out.append({
            "unique_ids": np.array([1000000000 + i], np.int64),
            "input_ids": rs.integers(0, 30522, T) * mask,
            "input_mask": mask,
            "segment_ids": (np.arange(T) >= valid // 2).astype(np.int64),
            "start_positions": np.array([valid // 3], np.int64),
            "end_positions": np.array([valid // 2], np.int64),
            "score": rs.standard_normal(3).astype(np.float32),
            "delta": np.array([-(i + 1), 2 ** 40], np.int64),
            "text": [f"question {i}".encode(), b"\x00\xff"],
        })
    return out


@pytest.mark.parametrize("data", [b"", b"a", b"123456789",
                                  bytes(range(256)) * 3 + b"tail"])
def test_crc32c_matches_jax(data):
    assert ttfr.crc32c(data) == jtfr._crc32c_py(data)
    assert ttfr._masked_crc(data) == jtfr._masked_crc(data)
    if data == b"123456789":
        assert ttfr.crc32c(data) == 0xE3069283     # RFC 3720 B.4


def test_files_are_byte_identical_both_ways(tmp_path):
    exs = _examples()
    recs_t = [ttfr.build_example(e) for e in exs]
    recs_j = [jtfr.build_example(e) for e in exs]
    assert recs_t == recs_j
    pt, pj = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    assert ttfr.write_records(pt, recs_t) == jtfr.write_records(pj, recs_j)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for reader_path in (pt, pj):
        for got, want in zip(ttfr.read_example_file(reader_path),
                             jtfr.read_example_file(reader_path)):
            assert got.keys() == want.keys()
            for k in want:
                if isinstance(want[k], list):
                    assert got[k] == want[k]
                else:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
    back = ttfr.read_example_file(pj)
    np.testing.assert_array_equal(back[0]["delta"], [-1, 2 ** 40])
    assert back[2]["text"] == [b"question 2", b"\x00\xff"]


def test_framing_errors_match_jax(tmp_path):
    path = str(tmp_path / "a.tfrecord")
    ttfr.write_records(path, [b"payload-bytes", b""])
    assert list(ttfr.read_records(path)) == [b"payload-bytes", b""]
    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="corrupt data CRC"):
        list(ttfr.read_records(path))
    assert len(list(ttfr.read_records(path, verify=False))) == 2
    open(path, "wb").write(bytes(raw[:20]))
    with pytest.raises(ValueError, match="truncated record body"):
        list(ttfr.read_records(path, verify=False))
    open(path, "wb").write(bytes(raw[:5]))
    with pytest.raises(ValueError, match="truncated record header"):
        list(ttfr.read_records(path))


def test_unpacked_wire_encodings_parse_as_jax():
    from analytics_zoo_tpu.onnx.proto import (_VARINT, _field, _write_varint,
                                              emit_bytes, emit_float)
    float_list = emit_float(1, 1.5) + emit_float(1, -2.0)
    int_list = (_field(1, _VARINT, _write_varint(7))
                + _field(1, _VARINT, _write_varint((1 << 64) - 3)))
    feats = (emit_bytes(1, emit_bytes(1, b"f") + emit_bytes(
                2, emit_bytes(2, float_list)))
             + emit_bytes(1, emit_bytes(1, b"i") + emit_bytes(
                2, emit_bytes(3, int_list)))
             + emit_bytes(1, emit_bytes(1, b"e") + emit_bytes(2, b"")))
    rec = emit_bytes(1, feats)
    got, want = ttfr.parse_example(rec), jtfr.parse_example(rec)
    assert got.keys() == want.keys() == {"f", "i", "e"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_examples_to_arrays_and_ragged_features(tmp_path):
    exs = _examples(4)
    got = ttfr.examples_to_arrays(exs, ["input_ids", "text"])
    want = jtfr.examples_to_arrays(exs, ["input_ids", "text"])
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    assert got["text"] == want["text"]
    assert sorted(ttfr.examples_to_arrays(exs)) == sorted(exs[0])
    assert ttfr.examples_to_arrays([]) == {}
    with pytest.raises(ValueError, match="ragged"):
        ttfr.examples_to_arrays([{"x": np.zeros(3)}, {"x": np.zeros(4)}])


def test_squad_file_feeds_featureset_and_tfdataset(tmp_path):
    for shard in range(2):
        ttfr.write_records(
            str(tmp_path / f"train-{shard:05d}.tf_record"),
            [ttfr.build_example({k: e[k] for k in SQUAD_KEYS})
             for e in _examples(5, seed=shard)])
    (tmp_path / "_SUCCESS").write_bytes(b"")      # skipped, as in JAX
    feats = ["input_ids", "segment_ids", "input_mask"]
    labels = ["start_positions", "end_positions"]
    fs = FeatureSet.from_tfrecord_file(str(tmp_path), feats, labels)
    jfs = JFeatureSet.from_tfrecord_file(str(tmp_path), feats, labels)
    assert len(fs) == len(jfs) == 10
    assert fs.features.keys() == jfs.features.keys()
    for k in feats:
        np.testing.assert_array_equal(fs.features[k], jfs.features[k])
    for k in labels:
        np.testing.assert_array_equal(fs.labels[k], jfs.labels[k])
        assert fs.labels[k].dtype == np.int64
    one = FeatureSet.from_tfrecord_file(str(tmp_path), ["input_ids"],
                                        ["start_positions"])
    assert one.features.shape == (10, 12) and one.labels.shape == (10, 1)
    default = FeatureSet.from_tfrecord_file(str(tmp_path))
    assert sorted(default.features) == sorted(SQUAD_KEYS)
    ds = TFDataset.from_tfrecord_file(
        str(tmp_path), feats, labels, batch_size=5,
        validation_file_path=str(tmp_path))
    assert len(ds) == 10 and ds.has_labels
    assert len(ds.get_validation_data()) == 10
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no tf.Example records"):
        FeatureSet.from_tfrecord_file(str(empty))
