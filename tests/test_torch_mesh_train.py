"""The sharded training step of the port against the JAX package's, on the
CPU.

The port's ``Estimator`` runs every position of its context's mesh on
``["cpu"] * 8``; the JAX estimator runs the same mesh shape over the
8-device CPU mesh.  Weights come from one numpy tree (``set_weights``),
data from numpy seeds, everything in f32.  Compared (the JAX tests'
tolerances, ``tests/test_mesh2d.py``): loss trajectories rtol 1e-5 /
atol 1e-6 and weights rtol 2e-5 / atol 2e-6, and ``bytes_per_device`` of
the weights and the optimizer state, which must be equal: both follow
from the shapes and the specs.  Dropout is off where the two packages are
compared (the port cannot draw JAX's per-step keys); the qkv key bias's
exact gradient is 0, so Adam legs compare losses only, as the JAX tests
do.

The JAX side runs with its persistent compile cache off (sharded programs
revived from it corrupt this jaxlib's heap) and only on the full 8-device
mesh: a mesh reshape is the port's alone.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common.config import ZooConfig as JZooConfig
from analytics_zoo_tpu.data import FeatureSet as JFeatureSet
from analytics_zoo_tpu.estimator import Estimator as JEstimator
from analytics_zoo_tpu.keras import initializers as jinit
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.keras import optimizers as JO
from analytics_zoo_tpu.keras.engine import KerasNet as JKerasNet
from analytics_zoo_tpu.keras.engine import Sequential as JSequential
from analytics_zoo_tpu.keras.layers.self_attention import (
    TransformerBlock as JTransformerBlock)
from analytics_zoo_tpu.parallel import bytes_per_device as jbytes
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu_torch.data import FeatureSet
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.keras import layers as L
from analytics_zoo_tpu_torch.keras import optimizers as TO
from analytics_zoo_tpu_torch.keras.engine import KerasNet, Sequential
from analytics_zoo_tpu_torch.keras.layers import self_attention
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    TransformerBlock)
from analytics_zoo_tpu_torch.parallel import (
    PartitionSpec as P, ShardedTensor, bytes_per_device, tree_bytes)

D, T, HEADS = 32, 8, 4
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
WEIGHT_TOL = dict(rtol=2e-5, atol=2e-6)


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


class JTinyTx(JKerasNet):
    """``tests/test_mesh2d.py``'s model: one post-LN block and a mean-pool
    regression head."""

    def __init__(self, attn_drop=0.0, **kw):
        super().__init__(**kw)
        self.blk = JTransformerBlock(D, HEADS, 64, hidden_drop=0.0,
                                     attn_drop=attn_drop, name="blk")

    def build(self, rng, input_shape=None):
        k1, k2 = jax.random.split(rng)
        pb, _ = self.blk.build(k1, (None, T, D))
        return {"blk": pb, "head": {"W": jinit.glorot_uniform(k2, (D, 1)),
                                    "b": jnp.zeros((1,))}}, {}

    def call(self, params, state, x, training, rng):
        h, _ = self.blk.call(params["blk"], {}, x, training, rng)
        return jnp.mean(h, axis=1) @ params["head"]["W"] \
            + params["head"]["b"], state


class TinyTx(KerasNet):
    """The same model from the port's ``TransformerBlock``."""

    def __init__(self, attn_drop=0.0):
        super().__init__(name="tiny")
        self.blk = TransformerBlock(D, HEADS, 64, hidden_drop=0.0,
                                    attn_drop=attn_drop, name="blk")
        self.head = nn.ParameterDict({"W": nn.Parameter(torch.zeros(D, 1)),
                                      "b": nn.Parameter(torch.zeros(1))})

    def forward(self, x, seed=None):
        h = self.blk(x, seed=seed)
        return h.mean(dim=1) @ self.head["W"] + self.head["b"]


@functools.lru_cache(maxsize=None)
def _tiny_tree():
    params, _ = JTinyTx(name="tiny").build(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _tiny_data(n=64):
    rs = np.random.RandomState(0)
    x = rs.randn(n, T, D).astype(np.float32)
    return x, (x[:, 0, :1] * 0.5).astype(np.float32)


def _jctx(dp, mp):
    cfg = JZooConfig()
    cfg.mesh.data, cfg.mesh.model = dp, mp
    return jctx.ZooContext(cfg, jctx._build_mesh(list(jax.devices()[:8]),
                                                 cfg.mesh))


def _tctx(dp, mp):
    mc = MeshConfig(data=dp, model=mp)
    return tctx.ZooContext(ZooConfig(mesh=mc), tctx._build_mesh(
        [torch.device("cpu")] * (dp * mp), mc))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _opt_bytes(est):
    return bytes_per_device({k: v for k, v in est.opt_state.items()
                             if k != "decayed"})


def _fs(pkg, x, y, device_tier=False):
    fs = pkg.from_ndarrays(x, y, shuffle=False)
    return fs.cache_device() if device_tier else fs


TIERS = {"single": ({}, False), "chained": ({"steps_per_dispatch": 2}, False),
         "device": ({"steps_per_dispatch": 2}, True)}


@functools.lru_cache(maxsize=None)
def _jax_tiny(dp, mp, tier="single", epochs=2, opt="sgd", **kw):
    """The JAX estimator's run (cached: several port runs compare with
    it): history, final weights and per-device bytes."""
    est_kw, device_tier = TIERS[tier]
    x, y = _tiny_data()
    est = JEstimator(JTinyTx(name="tiny"), _opt(JO, opt), "mse",
                     ctx=_jctx(dp, mp), **est_kw, **kw)
    hist = est.train(_fs(JFeatureSet, x, y, device_tier), batch_size=16,
                     epochs=epochs, variables=(_tiny_tree(), {}))
    return ([h["loss"] for h in hist], _flat(est.params),
            jbytes(est.params), jbytes(est.opt_state), est.global_step)


def _opt(pkg, name):
    return {"sgd": lambda: pkg.SGD(lr=0.05, momentum=0.9),
            "adam": lambda: pkg.Adam(lr=0.01),
            "adamw_bf16": lambda: pkg.AdamWeightDecay(
                lr=0.01, total=8, state_dtype="bfloat16"),
            "lamb": lambda: pkg.LAMB(lr=0.01)}[name]()


def _port_tiny(dp, mp, tier="single", epochs=2, opt="sgd", net=None,
               seed=None, **kw):
    est_kw, device_tier = TIERS[tier]
    x, y = _tiny_data()
    net = net or TinyTx()
    net.set_weights(_tiny_tree())
    ctx = _tctx(dp, mp) if dp * mp > 1 else None
    est = Estimator(net, _opt(TO, opt), "mse", ctx=ctx,
                    **({} if ctx else {"device": "cpu"}), **est_kw, **kw)
    hist = est.train(_fs(FeatureSet, x, y, device_tier), batch_size=16,
                     epochs=epochs, seed=seed)
    return est, [h["loss"] for h in hist]


def _same_weights(net, want, tol=WEIGHT_TOL):
    got = dict(net.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w, **tol,
                                   err_msg=name)


@pytest.mark.parametrize("zero", [False, True], ids=["weights", "zero"])
@pytest.mark.parametrize("dp,mp", [(4, 2), (2, 4)], ids=["dp4mp2",
                                                         "dp2mp4"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_trajectory_and_bytes_match_jax(tier, dp, mp, zero):
    """Each port run against the JAX run of its mesh and ZeRO setting in
    the single-step tier (the JAX tests hold its tiers to one another at
    these tolerances), and at dp 4 x mp 2 with ZeRO against the JAX run
    of its own tier (each JAX tier a compile of its own)."""
    ref_tier = tier if (dp, mp, zero) == (4, 2, True) else "single"
    losses, weights, pbytes, obytes, steps = _jax_tiny(
        dp, mp, ref_tier, shard_optimizer=zero)
    est, got = _port_tiny(dp, mp, tier, shard_optimizer=zero)
    np.testing.assert_allclose(got, losses, **LOSS_TOL)
    _same_weights(est.model, weights)
    assert est.global_step == steps == 8
    assert bytes_per_device(est.params) == pbytes
    assert _opt_bytes(est) == obytes
    # Megatron-placed weights: the matched leaves 1/mp per position
    assert pbytes < tree_bytes(est.params)
    if mp == 4:
        assert pbytes * 2 <= tree_bytes(est.params)
    if zero:        # the moments carve both axes
        assert obytes * 4 <= tree_bytes(
            {k: v for k, v in est.opt_state.items() if k != "decayed"})


def test_placement_follows_the_megatron_and_zero_specs():
    est, _ = _port_tiny(4, 2, epochs=1, shard_optimizer=True)
    spec = lambda t: t.sharding.spec
    assert spec(est.params["blk.attn.qkv.W"]) == P(None, "model")
    assert spec(est.params["blk.ffn.fc2.W"]) == P("model", None)
    assert spec(est.params["blk.ln1.gamma"]) == P()
    assert spec(est.opt_state["trace"]["blk.attn.qkv.W"]) == \
        P("data", "model")
    assert spec(est.opt_state["trace"]["blk.ffn.fc2.W"]) == \
        P("model", "data")
    assert spec(est.opt_state["trace"]["blk.attn.qkv.b"]) == P("model")
    assert spec(est.opt_state["count"]) == P()
    # the weights the model computes with are the gathered masters
    for name, p in est.model.named_parameters():
        assert torch.equal(est.params[name].gather(), p.detach()), name


@pytest.mark.parametrize("opt", ["adam", "adamw_bf16"])
def test_adam_family_losses_and_bytes_match_jax(opt):
    losses, _, pbytes, obytes, _ = _jax_tiny(4, 2, opt=opt,
                                             shard_optimizer=True)
    est, got = _port_tiny(4, 2, opt=opt, shard_optimizer=True)
    np.testing.assert_allclose(got, losses, **LOSS_TOL)
    # two optax counts (Adam's and the schedule's), the bf16 first moment
    assert bytes_per_device(est.params) == pbytes
    assert _opt_bytes(est) == obytes
    if opt == "adamw_bf16":
        assert all(m.dtype == torch.bfloat16
                   for m in est.opt_state["mu"].values())


def test_accumulation_matches_jax_and_a_single_pass():
    losses, weights, _, obytes, _ = _jax_tiny(4, 2, grad_accum_steps=2,
                                              shard_optimizer=True)
    est, got = _port_tiny(4, 2, grad_accum_steps=2, shard_optimizer=True)
    np.testing.assert_allclose(got, losses, **LOSS_TOL)
    _same_weights(est.model, weights)
    assert _opt_bytes(est) == obytes
    # the accumulator is sharded as the gradient: a block a position
    acc = est._plan.acc["blk.attn.qkv.W"]
    assert acc.sharding.spec == P("data", "model")
    assert len(acc.unique_shards()) == 8
    # two microbatches average to the whole batch's gradient
    one, single = _port_tiny(4, 2, shard_optimizer=True)
    np.testing.assert_allclose(got, single, **LOSS_TOL)
    _same_weights(est.model, {n: p.detach().numpy() for n, p
                              in one.model.named_parameters()})


def test_clip_norm_over_shards_matches_jax():
    losses, weights, _, _, _ = _jax_tiny(4, 2, shard_optimizer=True,
                                         gradient_clip_norm=0.05)
    est, got = _port_tiny(4, 2, shard_optimizer=True,
                          gradient_clip_norm=0.05)
    np.testing.assert_allclose(got, losses, **LOSS_TOL)
    _same_weights(est.model, weights)


def test_shard_model_false_is_the_replicated_run(monkeypatch):
    calls = []
    inner = self_attention.sharded_flash_attention
    monkeypatch.setattr(self_attention, "sharded_flash_attention",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    runs = {}
    for dp, mp, kw in ((8, 1, {}), (4, 2, {"shard_model": False})):
        est, losses = _port_tiny(dp, mp, net=TinyTx(attn_drop=0.3),
                                 seed=3, **kw)
        runs[mp] = (est, losses)
        assert bytes_per_device(est.params) == tree_bytes(est.params)
    # dropout on: the data-only view keeps attention unsharded, so the two
    # runs draw the same masks
    assert calls == []
    np.testing.assert_allclose(runs[2][1], runs[1][1], **LOSS_TOL)
    _same_weights(runs[2][0].model, {n: p.detach().numpy() for n, p
                                     in runs[1][0].model.named_parameters()})


def test_ctx_wins_over_the_global_context(monkeypatch):
    calls = []
    inner = self_attention.sharded_flash_attention
    monkeypatch.setattr(self_attention, "sharded_flash_attention",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    tctx.init_zoo_context(ZooConfig(mesh=MeshConfig(data=4, model=2)),
                          devices=["cpu"] * 8)
    est1, h1 = _port_tiny(8, 1)           # explicit 1D under a global 2D
    assert calls == []
    assert bytes_per_device(est1.params) == tree_bytes(est1.params)
    tctx.reset_context()
    tctx.init_zoo_context(ZooConfig(mesh=MeshConfig(data=8, model=1)),
                          devices=["cpu"] * 8)
    est2, h2 = _port_tiny(4, 2)           # explicit 2D under a global 1D
    assert len(calls) == 8                # 8 steps, one layer
    assert bytes_per_device(est2.params) < tree_bytes(est2.params)
    np.testing.assert_allclose(h1, h2, **LOSS_TOL)
    # no ctx=: the global context's mesh is the estimator's
    net = TinyTx()
    net.set_weights(_tiny_tree())
    est3 = Estimator(net, TO.SGD(lr=0.05), "mse")
    assert est3.ctx is tctx.current_context() and est3.device.type == "cpu"


def test_a_mesh_over_two_devices_trains_replicated_or_raises():
    """A mesh whose positions lie on two devices no longer trains on the
    model's device alone, nor raises: it runs the per-position step, each
    data position's replica and (under ZeRO) its slots on its own device,
    with the weights placed by the Megatron rules over "model" where
    ``shard_model`` asks for it (each position's block on its device), or
    every position a data position where it does not.  A ``sequence``
    axis no longer raises: the positions that differ along it hold the
    same rows and replica, so the data positions are its first
    coordinate's, and the ZeRO blocks lie on every position.  Nothing is
    computed on ``meta``: the per-position step's numbers are held in
    ``tests/test_torch_positions.py`` and
    ``tests/test_torch_job_layouts.py``."""
    mc = MeshConfig(data=4, model=2)
    devices = [torch.device("cpu")] * 4 + [torch.device("meta")] * 4
    ctx = tctx.ZooContext(ZooConfig(mesh=mc), tctx._build_mesh(devices, mc))
    for zero, model in ((False, False), (True, False), (True, True)):
        net = TinyTx()
        net.set_weights(_tiny_tree())
        est = Estimator(net, _opt(TO, "sgd"), "mse", ctx=ctx, device="cpu",
                        shard_optimizer=zero, shard_model=model)
        est._prepare(seed=0)
        assert est._per_position and est._pp.n == (4 if model else 8)
        for p in est.params.values():
            assert [t.device for t in p.shards] == devices
        assert est.params["blk.attn.qkv.W"].sharding.spec == (
            P(None, "model") if model else P())
        trace = est.opt_state["trace"]["blk.attn.qkv.W"]
        assert ({t.device for t in trace.shards} == set(devices) if zero
                else {t.device for t in trace.shards} == {devices[0]})
    mc = MeshConfig(data=4, sequence=2)
    est = Estimator(TinyTx(), TO.SGD(lr=0.05, momentum=0.9), "mse",
                    device="cpu", shard_optimizer=True,
                    ctx=tctx.ZooContext(ZooConfig(mesh=mc),
                                        tctx._build_mesh(devices, mc)))
    est._prepare(seed=0)
    assert est._per_position and est._pp.n == 4
    assert est._pp.positions == [0, 2, 4, 6]
    assert [d.type for d in est._pp.devs] == ["cpu", "cpu", "meta", "meta"]
    trace = est.opt_state["trace"]["blk.attn.qkv.W"]
    assert [t.device for t in trace.shards] == devices


def test_eval_and_predict_under_the_2d_mesh(monkeypatch):
    est, _ = _port_tiny(4, 2, shard_optimizer=True)
    x, y = _tiny_data()
    fs = FeatureSet.from_ndarrays(x, y, shuffle=False)
    calls = []
    inner = self_attention.sharded_flash_attention
    monkeypatch.setattr(self_attention, "sharded_flash_attention",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    scores = est.evaluate(fs, batch_size=16)
    preds = est.predict(fs, batch_size=16)
    assert len(calls) == 8 and preds.shape == (64, 1)
    plain = Estimator(est.model, None, "mse", device="cpu")
    np.testing.assert_allclose(preds, plain.predict(fs, batch_size=16),
                               atol=1e-6, rtol=0)
    assert scores["loss"] == pytest.approx(
        plain.evaluate(fs, batch_size=16)["loss"], rel=1e-6)


def test_gauges_read_the_placed_trees():
    est, _ = _port_tiny(2, 4, shard_optimizer=True, grad_accum_steps=2)
    snap = obs.get_registry().snapshot()
    value = lambda name, key=(): snap[name]["series"][key]
    assert value("zoo_estimator_weight_bytes_per_device") == \
        float(bytes_per_device(est.params))
    assert value("zoo_estimator_opt_state_bytes_per_device") == \
        float(_opt_bytes(est))
    assert value("zoo_train_mesh_shape", (("axis", "data"),)) == 2.0
    assert value("zoo_train_mesh_shape", (("axis", "model"),)) == 4.0
    assert value("zoo_train_accum_microbatches") == 2.0


def test_batch_checks_say_what_jax_says():
    x, y = _tiny_data()
    net = TinyTx()
    with pytest.raises(ValueError) as got:
        Estimator(net, TO.SGD(lr=0.05), "mse", ctx=_tctx(4, 2),
                  grad_accum_steps=2).train(
            FeatureSet.from_ndarrays(x, y), batch_size=12)
    with pytest.raises(ValueError) as want:
        JEstimator(JTinyTx(name="tiny"), JO.SGD(lr=0.05), "mse",
                   ctx=_jctx(4, 2), grad_accum_steps=2).train(
            JFeatureSet.from_ndarrays(x, y), batch_size=12)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        next(FeatureSet.from_ndarrays(x, y).batches(12, ctx=_tctx(8, 1)))
    with pytest.raises(ValueError) as want:
        next(JFeatureSet.from_ndarrays(x, y).batches(12, ctx=_jctx(8, 1)))
    assert str(got.value) == str(want.value)


def _linear_data(n=256, d=16, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    w = rs.randn(d, 1).astype(np.float32)
    return x, (x @ w + 0.05 * rs.randn(n, 1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _net_tree():
    net = JSequential([JL.Dense(64, activation="tanh", input_shape=(16,),
                                name="h"), JL.Dense(1, name="out")])
    params, _ = net.build(jax.random.PRNGKey(1), (None, 16))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("opt", ["sgd", "lamb"])
def test_zero_at_dp8_matches_jax(opt):
    """``tests/test_zero_sharding.py``'s net under ZeRO at dp 8: LAMB's
    trust ratios are taken over each whole leaf from its 8 blocks."""
    x, y = _linear_data()
    jnet = JSequential([JL.Dense(64, activation="tanh", input_shape=(16,),
                                 name="h"), JL.Dense(1, name="out")])
    jest = JEstimator(jnet, _opt(JO, opt), "mse", ctx=_jctx(8, 1),
                      shard_optimizer=True)
    jhist = jest.train(JFeatureSet.from_ndarrays(x, y, shuffle=False),
                       batch_size=32, epochs=1, variables=(_net_tree(), {}))
    net = Sequential([L.Dense(64, activation="tanh", input_shape=(16,),
                              name="h"), L.Dense(1, name="out")],
                     device="cpu")
    net.set_weights(_net_tree())
    est = Estimator(net, _opt(TO, opt), "mse", ctx=_tctx(8, 1),
                    shard_optimizer=True)
    hist = est.train(FeatureSet.from_ndarrays(x, y, shuffle=False),
                     batch_size=32, epochs=1)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], **LOSS_TOL)
    _same_weights(net, _flat(jest.params))
    assert bytes_per_device(est.params) == jbytes(jest.params)
    assert _opt_bytes(est) == jbytes(jest.opt_state)
    assert _opt_bytes(est) * 4 <= tree_bytes(
        {k: v for k, v in est.opt_state.items() if k != "decayed"})


@pytest.mark.parametrize("tier", ["single", "device"])
def test_bf16_adamw_update_sharded_equals_unsharded(tier):
    """The bench's update (AdamW with a bf16 first moment, mixed
    precision, bf16 gradients) at data 2 x model 2 with ZeRO: the same
    forward and backward, an elementwise update on blocks, so weights and
    both moments equal the unsharded run's to the bit."""
    kw = dict(opt="adamw_bf16", mixed_precision=True, grad_dtype="bfloat16")
    full = lambda t: t.gather() if isinstance(t, ShardedTensor) else t
    runs = []
    for dp, mp, extra in ((1, 1, {}), (2, 2, {"shard_optimizer": True})):
        est, losses = _port_tiny(dp, mp, tier, **kw, **extra)
        state = {n: p.detach() for n, p in est.model.named_parameters()}
        state.update({f"{k}.{n}": full(t) for k in ("mu", "nu")
                      for n, t in est.opt_state[k].items()})
        runs.append((losses, state))
    (want_l, want), (got_l, got) = runs
    assert got_l == want_l
    assert isinstance(got["mu.blk.attn.qkv.W"], torch.Tensor)
    assert got["mu.blk.attn.qkv.W"].dtype == torch.bfloat16
    for name, w in want.items():
        assert torch.equal(got[name], w), name


class EmbedNet(KerasNet):
    def __init__(self):
        super().__init__(name="embed_net")
        self.embed = L.Embedding(40, 8, partition="model", name="embed")
        self.head = nn.Parameter(torch.full((8, 1), 0.1))

    def forward(self, x, seed=None):
        return self.embed(x).mean(dim=1) @ self.head


def test_embedding_partition_is_stored_and_its_vocab_shards():
    from analytics_zoo_tpu.keras.layers import Embedding as JEmbedding
    assert L.Embedding(4, 2, partition="model").partition == \
        JEmbedding(4, 2, partition="model").partition == "model"
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 40, (32, 5)).astype(np.int32)
    y = rs.randn(32, 1).astype(np.float32)
    runs = []
    for ctx in (_tctx(2, 4), None):
        net = EmbedNet()
        torch.manual_seed(0)
        net.embed.reset_parameters()
        est = Estimator(net, TO.SGD(lr=0.1), "mse", ctx=ctx,
                        **({} if ctx else {"device": "cpu"}))
        hist = est.train(FeatureSet.from_ndarrays(ids, y, shuffle=False),
                         batch_size=8, epochs=2)
        runs.append((est, [h["loss"] for h in hist]))
    table = runs[0][0].params["embed.embeddings"]
    assert table.sharding.spec == P("model", None)
    assert table.sharding.shard_shape(table.shape) == (10, 8)
    np.testing.assert_allclose(runs[0][1], runs[1][1], **LOSS_TOL)
    np.testing.assert_allclose(table.gather().numpy(),
                               runs[1][0].model.embed.embeddings.detach()
                               .numpy(), atol=1e-6, rtol=0)


def test_keras_fit_trains_sharded_under_the_global_context():
    """``KerasNet.fit``'s estimator options reach the sharded step: the
    global context's mesh is the estimator's."""
    x, y = _linear_data()
    runs = []
    for sharded in (True, False):
        net = Sequential([L.Dense(64, activation="tanh", input_shape=(16,),
                                  name="h"), L.Dense(1, name="out")],
                         device="cpu")
        net.set_weights(_net_tree())
        net.compile(TO.SGD(lr=0.05, momentum=0.9), "mse")
        if sharded:
            tctx.init_zoo_context(ZooConfig(mesh=MeshConfig(data=8)),
                                  devices=["cpu"] * 8)
        hist = net.fit(FeatureSet.from_ndarrays(x, y, shuffle=False),
                       batch_size=32, shard_optimizer=True)
        tctx.reset_context()
        est = net._last_estimator
        runs.append(([h["loss"] for h in hist], est))
    (sharded, zero), (plain, alone) = runs
    assert zero.ctx is not None and alone.ctx is None
    assert _opt_bytes(zero) * 4 <= tree_bytes(
        {k: v for k, v in zero.opt_state.items() if k != "decayed"})
    np.testing.assert_allclose(sharded, plain, **LOSS_TOL)
