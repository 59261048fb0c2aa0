"""The recommendation models on the card against the same models on the CPU.

Marked ``cuda``: every test skips with a reason where no CUDA device is
visible.  On a machine with a card:
``python -m pytest --noconftest tests/test_torch_cuda_recommendation.py``.
f32 with TF32 off: forwards within 1e-5 of the CPU's, training losses
within 1e-4 relative.  Out-of-range ids must give NaN rows on the card
without a device-side assert (the CUDA context stays usable).
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.keras import engine
from analytics_zoo_tpu_torch.models import (ColumnFeatureInfo, NeuralCF,
                                            WideAndDeep,
                                            assemble_feature_dict)
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops.attention import flash_attention

pytestmark = pytest.mark.cuda

NCF = dict(user_count=6040, item_count=3706, user_embed=64, item_embed=64,
           mf_embed=64, hidden_layers=(128, 64, 32))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card run of the models")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(build):
    """The same model on the CPU and on the card, one set of weights."""
    engine.reset_uids()
    cpu = build("cpu")
    engine.reset_uids()
    card = build("cuda")
    card.set_weights(cpu.get_weights())
    return cpu, card


def _ids(n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 6041, (n, 1)).astype(np.int32),
            rs.randint(1, 3707, (n, 1)).astype(np.int32)]


@pytest.mark.parametrize("layout", [{}, dict(fused_tables=False),
                                    dict(include_mf=False)])
def test_ncf_on_the_card_matches_the_cpu(dev, layout):
    cpu, card = _pair(lambda d: NeuralCF(device=d, **NCF, **layout))
    x = _ids(1024)
    want = cpu.predict(x, batch_size=1024)
    got = card.predict(x, batch_size=1024)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_out_of_range_ids_on_the_card_give_nan_rows(dev):
    cpu, card = _pair(lambda d: NeuralCF(device=d, **NCF))
    x = [np.array([[1], [6041], [-1], [-6042], [10 ** 7]], np.int32),
         np.array([[5], [6], [3707], [-3707], [1]], np.int32)]
    want = cpu.predict(x, batch_size=8)
    got = card.predict(x, batch_size=8)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any(axis=1).tolist() == [False, True, True, True,
                                                  True]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the context survived: the next request is answered
    x2 = _ids(64, seed=1)
    np.testing.assert_allclose(card.predict(x2, batch_size=64),
                               cpu.predict(x2, batch_size=64), atol=1e-5,
                               rtol=0)


def test_ncf_and_wide_and_deep_train_on_the_card_as_on_the_cpu(dev):
    ci = ColumnFeatureInfo(
        wide_base_cols=["occupation", "gender"], wide_base_dims=[21, 3],
        wide_cross_cols=["age-gender"], wide_cross_dims=[100],
        indicator_cols=["occupation", "gender"], indicator_dims=[21, 3],
        embed_cols=["userId", "itemId"], embed_in_dims=[6040, 3952],
        embed_out_dims=[64, 64], continuous_cols=["age"])
    rs = np.random.RandomState(0)
    n = 4096
    cols = {"occupation": rs.randint(0, 21, n), "gender": rs.randint(0, 3, n),
            "age-gender": rs.randint(0, 100, n),
            "userId": rs.randint(1, 6041, n), "itemId": rs.randint(1, 3953, n),
            "age": rs.randint(18, 60, n).astype(np.float32)}
    y = rs.randint(0, 2, n).astype(np.int32)
    cases = [(lambda d: NeuralCF(device=d, **NCF), _ids(n, seed=2)),
             (lambda d: WideAndDeep(column_info=ci, device=d),
              assemble_feature_dict(cols, ci))]
    for build, x in cases:
        cpu, card = _pair(build)
        losses = []
        for m in (cpu, card):
            m.compile("adam", "sparse_categorical_crossentropy")
            hist = m.fit(x, y, batch_size=1024, nb_epoch=2)
            losses.append([h["loss"] for h in hist])
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def test_pallas_backend_launches_the_kernel(dev):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 64, 64, generator=g).to(dev)
               for _ in range(3))
    before = _kernels.flash_fwd.launches
    out = flash_attention(q, k, v, backend="pallas")
    assert _kernels.flash_fwd.launches == before + 1
    ref = flash_attention(q, k, v, backend="jnp")
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
