"""The port's Seq2seq against the JAX package's, on the CPU.

Built in both packages from the same JAX weights (1 and 2 layers, a
separate decoder vocabulary): the teacher-forced probabilities from a
list and from a dict input (1e-5), greedy ``infer`` tokens equal (with and
without ``stop_sign``), and 3 Adam ``fit`` steps with the same shuffle
(losses 1e-5 relative, weights 1e-5).
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models import Seq2seq as JSeq2seq
from analytics_zoo_tpu_torch.models import Seq2seq as TSeq2seq

ATOL = 1e-5
V, T = 12, 5


def _pair(**kw):
    jm = JSeq2seq(V, embed_dim=16, hidden=32, **kw)
    tm = TSeq2seq(V, embed_dim=16, hidden=32, device="cpu", **kw)
    params, state = jm.init(jax.random.PRNGKey(0),
                            input_shape=[(None, T), (None, T)])
    tm.set_weights((jax.tree_util.tree_map(np.asarray, params), {}))
    return jm, tm


def _copy_task(n, seed=0):
    rs = np.random.RandomState(seed)
    src = rs.randint(2, V, (n, T)).astype(np.int32)
    dec_in = np.concatenate([np.ones((n, 1), np.int32), src[:, :-1]], axis=1)
    return src, dec_in


@pytest.mark.parametrize("kw", [dict(), dict(num_layers=2),
                                dict(num_layers=2, decoder_vocab_size=7)],
                         ids=["1-layer", "2-layer", "decoder-vocab"])
def test_forward_and_infer_match_jax(kw):
    jm, tm = _pair(**kw)
    src, dec_in = _copy_task(6)
    dec_in = dec_in % tm.decoder_vocab
    params, state = jm._variables
    want = np.asarray(jm.apply(params, state, [src, dec_in])[0])
    for x in ([src, dec_in], {"enc": src, "dec": dec_in}):
        got = tm.predict_fn({k: torch.from_numpy(v) for k, v in x.items()}
                            if isinstance(x, dict)
                            else [torch.from_numpy(v) for v in x])
        assert got.shape == (6, T, tm.decoder_vocab)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tm.infer(src, start_sign=1, max_seq_len=8),
                                  jm.infer(src, start_sign=1, max_seq_len=8))
    np.testing.assert_array_equal(
        tm.infer(src[0], start_sign=1, max_seq_len=4),
        jm.infer(src[0], start_sign=1, max_seq_len=4))


def test_infer_stops_at_the_stop_sign_as_jax():
    jm, tm = _pair(num_layers=2)
    src, _ = _copy_task(1, seed=3)
    free = jm.infer(src, start_sign=1, max_seq_len=10)
    stop = int(free[0, 2])                 # the token it emits third
    want = jm.infer(src, start_sign=1, max_seq_len=10, stop_sign=stop)
    got = tm.infer(src, start_sign=1, max_seq_len=10, stop_sign=stop)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] <= 3 and got[0, -1] == stop


def test_three_fit_steps_match_jax():
    jm, tm = _pair(num_layers=2)
    src, dec_in = _copy_task(48, seed=1)
    for m in (jm, tm):
        m.compile("adam", "sparse_categorical_crossentropy")
    x = {"enc": src, "dec": dec_in}
    jh = jm.fit(x, src, batch_size=16, nb_epoch=1)
    th = tm.fit(x, src, batch_size=16, nb_epoch=1)
    assert th[0]["loss"] == pytest.approx(jh[0]["loss"], rel=1e-5)
    jw = jax.tree_util.tree_map(np.asarray, jm.get_weights()[0])
    tw = tm.get_weights()[0]
    assert set(tw) == set(jw) == {"enc_embed", "dec_embed", "head",
                                  "enc_lstm_0", "dec_lstm_0", "enc_lstm_1",
                                  "dec_lstm_1"}
    for key, w in jw.items():
        for name, a in (w.items() if isinstance(w, dict) else [("", w)]):
            b = tw[key][name] if name else tw[key]
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=0,
                                       err_msg=f"{key}.{name}")


def test_seeded_construction_is_repeatable():
    a = TSeq2seq(V, device="cpu", generator=torch.Generator().manual_seed(2))
    b = TSeq2seq(V, device="cpu", generator=torch.Generator().manual_seed(2))
    for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), n
    assert float(a.enc_embed.detach().abs().max()) <= 0.05
    assert a.compute_output_shape(None) == (None, None, V)
