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
    "adamax": lambda M: M.Adamax(lr=1e-2, decay=0.02),
    "adagrad": lambda M: M.Adagrad(lr=0.05),
    "adadelta": lambda M: M.Adadelta(lr=1.0, rho=0.9),
    "rmsprop": lambda M: M.RMSprop(lr=1e-3, rho=0.8, decay=0.01),
    "lamb": lambda M: M.LAMB(lr=1e-2, weight_decay=0.05),
    "lamb_poly_warmup": lambda M: M.LAMB(
        schedule=M.PolyWarmup(1e-2, 4, 20)),
    "lars": lambda M: M.LARS(lr=0.5, weight_decay=1e-3),
    "lars_nesterov_warmup_poly": lambda M: M.LARS(
        schedule=M.LarsWarmupPoly(1.0, 5, 20, end_lr=1e-3), nesterov=True,
        trust_coefficient=0.01, epsilon=1e-6),
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
    # both evaluate the schedule in f32, the port from a count tensor
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
    # every optimizer name of the JAX registry is ported now; an unknown
    # name and an unknown state dtype raise
    assert TO.get("adam").name == "adam"
    assert TO.get("AdamWeightDecay").name == "adam_weight_decay"
    opt = TO.SGD()
    assert TO.get(opt) is opt
    with pytest.raises(ValueError, match="unknown optimizer"):
        TO.get("lion")
    for name in ("adagrad", "adamax", "adadelta", "rmsprop", "lamb",
                 "lars"):
        assert TO.get(name).name == JO.get(name).name == name
    p = {"w": torch.zeros(3)}
    st = TO.AdamWeightDecay(state_dtype="bfloat16").init(p)
    assert st["mu"]["w"].dtype == torch.bfloat16
    assert st["nu"]["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="state_dtype"):
        TO.AdamWeightDecay(state_dtype="int8")


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_bf16_first_moment_matches_optax_mu_dtype(grad_dtype):
    # optax's mu_dtype=bf16 step as the JAX estimator runs it (jitted: XLA
    # rounds the constants to bf16 and keeps a bf16 product that feeds an
    # f32 sum unrounded), with f32 and with bf16 gradients (the bench's
    # grad_dtype); the two agree to 1e-6 of the parameters after 20 steps
    # and the stored moments to bf16's rounding (2**-7 relative)
    rs = np.random.default_rng(3)
    p0 = _tree(rs, 0.05)
    grads = [_tree(rs, 0.01) for _ in range(20)]
    make = lambda M: M.AdamWeightDecay(lr=1e-2, warmup_portion=0.2,
                                       total=16, state_dtype="bfloat16")
    jopt, topt = make(JO), make(TO)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    jstep = jax.jit(lambda g, s, p: jopt.update(g, s, p))
    tp = {k: torch.from_numpy(v.copy()) for k, v in _flat(p0).items()}
    tstate = topt.init(tp)
    for g in grads:
        jg = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).astype(grad_dtype), g)
        upd, jstate = jstep(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, {k: torch.from_numpy(v).to(getattr(torch,
                                                           grad_dtype))
                         for k, v in _flat(g).items()}, tstate)
    want = _flat(jax.tree_util.tree_map(np.asarray, jp))
    for k, v in want.items():
        np.testing.assert_allclose(tp[k].numpy(), v, atol=1e-6, rtol=0)
    jmu = _flat(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jstate[0].mu))
    for k, v in jmu.items():
        np.testing.assert_allclose(tstate["mu"][k].float().numpy(), v,
                                   rtol=2 ** -7, atol=1e-9)


class _NoHostRead:
    """Makes any read of a tensor's value on the host raise."""

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n)
                      for n in ("item", "__bool__", "__float__", "__int__",
                                "tolist", "numpy")}

        def refuse(*a, **k):
            raise AssertionError("the update read a tensor on the host")
        for n in self.saved:
            setattr(torch.Tensor, n, refuse)

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_reads_nothing_on_the_host(name):
    # the device-count form: the count is a 0-d int32 tensor and the step
    # (schedule, bias corrections, trust ratios) never leaves the tensors,
    # so a CUDA graph can replay it
    rs = np.random.default_rng(5)
    tp = {k: torch.from_numpy(v) for k, v in _flat(_tree(rs, 0.05)).items()}
    g = {k: torch.from_numpy(v) for k, v in _flat(_tree(rs, 0.01)).items()}
    opt = OPTIMIZERS[name](TO)
    state = opt.init(tp)
    assert state["count"].dtype == torch.int32 and state["count"].dim() == 0
    with _NoHostRead():
        for _ in range(3):
            opt.update(tp, g, state)
    assert int(state["count"]) == 3
    jopt = OPTIMIZERS[name](JO)
    for step in (0, 3, 17):
        assert opt.learning_rate(step) == pytest.approx(
            jopt.learning_rate(step), rel=1e-6)
