"""The port's optimizers against the JAX package's (optax), on the CPU.

Both sides start from the same parameters (a BERT-classifier-shaped tree,
values at the scale of the initialisers) and take 20 steps on the same
gradient sequence from a numpy seed; every parameter must agree to 1e-6
after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from analytics_zoo_tpu.keras import optimizers as JO
from analytics_zoo_tpu_torch.keras import optimizers as TO

SHAPES = {
    "bert": {"token_embed": (11, 8), "position_embed": (6, 8),
             "pooler": {"W": (8, 8), "b": (8,)},
             "embed_ln": {"gamma": (8,), "beta": (8,)},
             "bert_classifier_bert_block0": {
                 "attn": {"qkv": {"W": (8, 24), "b": (24,)}},
                 "ln1": {"gamma": (8,), "beta": (8,)}}},
    "head": {"W": (8, 2), "b": (2,)},
}


def _tree(rs, scale, shapes=SHAPES):
    return {k: _tree(rs, scale, v) if isinstance(v, dict)
            else (rs.standard_normal(v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


OPTIMIZERS = {
    "adam": lambda M: M.Adam(lr=1e-2),
    "adam_decay": lambda M: M.Adam(lr=1e-2, beta_1=0.8, epsilon=1e-6,
                                   decay=0.05),
    "sgd": lambda M: M.SGD(lr=0.1),
    "sgd_momentum": lambda M: M.SGD(lr=0.1, momentum=0.9, decay=0.01),
    "sgd_nesterov": lambda M: M.SGD(lr=0.1, momentum=0.9, nesterov=True),
    "adam_weight_decay": lambda M: M.AdamWeightDecay(
        lr=1e-2, warmup_portion=0.2, total=16, weight_decay=0.1),
    "adam_weight_decay_poly2": lambda M: M.AdamWeightDecay(
        schedule=M.PolyWarmup(1e-2, 3, 20, power=2.0, end_lr=1e-4),
        weight_decay=0.05),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_twenty_steps_match_optax(name):
    rs = np.random.default_rng(0)
    p0 = _tree(rs, 0.05)
    grads = [_tree(rs, 0.01) for _ in range(20)]
    jopt, topt = OPTIMIZERS[name](JO), OPTIMIZERS[name](TO)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in _flat(p0).items()}
    tstate = topt.init(tp)
    for step, g in enumerate(grads):
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, {k: torch.from_numpy(v)
                         for k, v in _flat(g).items()}, tstate)
        want = _flat(jax.tree_util.tree_map(np.asarray, jp))
        for k, v in want.items():
            np.testing.assert_allclose(tp[k].numpy(), v, atol=1e-6, rtol=0,
                                       err_msg=f"{k} at step {step}")
    assert tstate["count"] == 20


def test_poly_warmup_schedule_matches_optax():
    # optax evaluates the schedule in f32; the port in f64
    for args in [(1e-3, 10, 100), (1e-3, 0, 50), (2e-2, 5, 30, 2.0, 1e-4),
                 (1e-2, 4, 12, 2.0, 0.0, 2.0)]:
        js, ts = JO.PolyWarmup(*args), TO.PolyWarmup(*args)
        for step in range(0, 120, 3):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-5,
                                       atol=1e-12, err_msg=str(args))


def test_decay_mask_matches_jax_on_the_classifier_tree():
    p0 = _tree(np.random.default_rng(1), 1.0)
    want = _flat(JO.default_decay_mask(p0))
    got = TO.default_decay_mask(_flat(p0))
    assert got == {k: bool(v) for k, v in want.items()}
    # the JAX substring rule: block params ("/bert_classifier...") and
    # biases, LayerNorms take no decay; embeddings, pooler W, head W do
    assert got["bert.token_embed"] and got["head.W"]
    assert not got["bert.bert_classifier_bert_block0.attn.qkv.W"]
    assert not got["head.b"] and not got["bert.embed_ln.gamma"]


def test_names_and_unported_options():
    assert TO.get("adam").name == "adam"
    assert TO.get("AdamWeightDecay").name == "adam_weight_decay"
    opt = TO.SGD()
    assert TO.get(opt) is opt
    with pytest.raises(ValueError, match="unknown optimizer"):
        TO.get("adagrad")
    for fn in (lambda: TO.AdamWeightDecay(state_dtype="bfloat16"),
               lambda: TO.get("lamb"), lambda: TO.LARS(lr=0.1)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()
