"""The port's hash dropout against the JAX package's, on the CPU.

Masks must be bit-identical (the backward rebuilds them from the seed, and
a seed must drop the same elements in both packages); ``as_seed`` and
``derive_seed`` must give the same int32 seeds.  Seeds of 2**31 and above
wrap to int32 in the port; the JAX side is given the wrapped value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import dropout as JD
from analytics_zoo_tpu_torch.ops import dropout as TD

SEEDS = [0, 1234, -7, 2**31 - 1, -2**31, 2**31 + 5, 2**32 + 9]
SALTS = [0, 1, 2, 0x417, 0x5eed, 12]


def _jax_seed(seed):
    return jnp.asarray(np.uint32(seed & 0xFFFFFFFF).view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_mask_bit_identical(seed):
    for shape in [(3, 5, 7), (2, 128, 96), (1,)]:
        for rate in (0.1, 0.5, 0.9):
            jm = np.asarray(JD._mask(shape, _jax_seed(seed), rate))
            tm = TD._mask(shape, TD.as_seed(seed), rate).numpy()
            assert tm.shape == shape and tm.dtype == np.bool_
            assert np.array_equal(jm, tm), (shape, rate)


def test_mask_bit_identical_above_2_pow_24_elements():
    shape = (2, (1 << 23) + 1)                 # 2**24 + 2 elements
    jm = np.asarray(JD._mask(shape, _jax_seed(99), 0.1))
    tm = TD._mask(shape, 99, 0.1).numpy()
    assert np.array_equal(jm, tm)
    assert 0.89 < tm.mean() < 0.91


@pytest.mark.parametrize("seed", SEEDS)
def test_as_seed_and_derive_seed_match(seed):
    js = _jax_seed(seed)
    assert TD.as_seed(seed) == int(JD.as_seed(js))
    for salt in SALTS:
        assert TD.derive_seed(seed, salt) == int(JD.derive_seed(js, salt))
    assert TD.as_seed(None) is None and TD.derive_seed(None, 1) is None


def test_as_seed_takes_ints_only():
    # ints, or one integer in a tensor (the training step's device seeds)
    assert TD.as_seed(np.int64(-3)) == -3
    t = TD.as_seed(torch.tensor(2**31 + 5))
    assert t.dtype == torch.int32 and t.shape == () and int(t) == -2**31 + 5
    for bad in (1.5, "7", True, torch.tensor(1.5), torch.tensor([1, 2]),
                torch.tensor(True)):
        with pytest.raises(TypeError, match="int"):
            TD.as_seed(bad)


@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_seeds_give_the_int_seeds_values(seed):
    # a seed (or salt) held in a tensor, as a device step counter is,
    # derives the same int32 seeds and the same masks as the int
    ts = torch.tensor(seed & 0xFFFFFFFF, dtype=torch.int64)
    assert int(TD.as_seed(ts)) == TD.as_seed(seed)
    for salt in SALTS:
        want = TD.derive_seed(seed, salt)
        for got in (TD.derive_seed(ts, salt),
                    TD.derive_seed(seed, torch.tensor(salt)),
                    TD.derive_seed(ts, torch.tensor(salt, dtype=torch.int32))):
            assert got.dtype == torch.int32 and int(got) == want
    for rate in (0.1, 0.5):
        assert torch.equal(TD._mask((3, 40), TD.as_seed(ts), rate),
                           TD._mask((3, 40), TD.as_seed(seed), rate))


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_values_and_gradient(rate):
    x = np.random.default_rng(0).standard_normal((4, 9, 16)) \
        .astype(np.float32)
    seed = 31
    want = np.asarray(JD.hash_dropout(jnp.asarray(x), rate, seed=seed))
    xt = torch.from_numpy(x).requires_grad_()
    y = TD.hash_dropout(xt, rate, seed=seed)
    np.testing.assert_allclose(y.detach().numpy(), want, atol=0, rtol=0)
    dy = torch.from_numpy(np.random.default_rng(1).standard_normal(
        x.shape).astype(np.float32))
    (dx,) = torch.autograd.grad(y, xt, dy)
    keep = TD._mask(x.shape, seed, rate).numpy()
    np.testing.assert_array_equal(
        dx.numpy(), np.where(keep, dy.numpy() * np.float32(1 / (1 - rate)),
                             0.0))


def test_no_seed_or_no_rate_is_identity():
    x = torch.randn(3, 4)
    assert TD.hash_dropout(x, 0.5) is x
    assert TD.hash_dropout(x, 0.0, seed=3) is x
    assert torch.equal(TD.hash_dropout(x, 0.5, rng=3),
                       TD.hash_dropout(x, 0.5, seed=3))
