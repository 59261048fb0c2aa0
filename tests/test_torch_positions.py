"""The per-position data-parallel step on the CPU, in one process.

``estimator/positions.py`` runs each data position of a mesh on its own
device and stream; here every position is the host (``["cpu"] * n``,
reached through the estimator's private selector), so the same
per-position code runs with no streams.  Held, at data 4 and at data 4 x
model 2 (Megatron-placed weights): against the JAX estimator on the
8-device CPU mesh (``tests/test_torch_mesh_train.py``'s runs, f32, SGD,
dropout off: losses and weights within 1e-5), with ZeRO against itself
without it (bar 0), against today's one-device step (1e-5, dropout on:
each position draws its rows of the global masks); the keep-masks of each
position against its rows of the global masks (bit for bit), ``predict``
/ ``evaluate`` against the unsharded ones, checkpoints across the two
steps, and meshes whose data positions alternate ``cpu`` and ``meta``:
every replica, row block, slot and updated block of a position lies on its
device (built, never computed: nothing runs on ``meta``).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu_torch.data import FeatureSet
from analytics_zoo_tpu_torch.data.sharded import (ShardedFeatureSet,
                                                  write_npz_shards)
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.estimator import estimator as TE
from analytics_zoo_tpu_torch.estimator.positions import Positions, rows_of
from analytics_zoo_tpu_torch.keras import optimizers as TO
from analytics_zoo_tpu_torch.ops import attention as TA
from analytics_zoo_tpu_torch.ops.dropout import _mask, process_offset
from analytics_zoo_tpu_torch.parallel import (
    PartitionSpec as P, ShardedTensor, bytes_per_device, distributed)
from analytics_zoo_tpu_torch.parallel.mesh import (
    Mesh, broadcast_from, reduce_ordered)

from test_torch_mesh_train import (D, HEADS, T, TinyTx, _fs, _jax_tiny,
                                   _opt, _tiny_data, _tiny_tree)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and an idle pool of
    eight would spin on the cores the suite's other workers share."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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


def _ctx(devices, data=None, model=1):
    mc = MeshConfig(data=data or len(devices) // model, model=model)
    return tctx.ZooContext(ZooConfig(mesh=mc), tctx._build_mesh(
        [torch.device(d) for d in devices], mc))


def _run(dp, positions=True, tier="single", epochs=2, opt="sgd", net=None,
         seed=None, ctx=None, fs=None, resume=False, model=1, **kw):
    """A port run of the tiny model at data ``dp`` x ``model`` on the
    host: the per-position step (the private selector) or today's; one
    position runs with no mesh."""
    est_kw, device_tier = TE_TIERS[tier]
    x, y = _tiny_data()
    net = net or TinyTx()
    net.set_weights(_tiny_tree())
    ctx = ctx or (_ctx(["cpu"] * dp * model, model=model)
                  if dp * model > 1 else None)
    scope = (TE._positions_on_shared_devices() if positions
             else contextlib.nullcontext())
    with scope:
        est = Estimator(net, _opt(TO, opt), "mse", ctx=ctx,
                        **({} if ctx else {"device": "cpu"}), **est_kw,
                        **kw)
    assert est._per_position == (positions and ctx is not None)
    hist = est.train(fs or _fs(FeatureSet, x, y, device_tier),
                     batch_size=16, epochs=epochs, seed=seed, resume=resume)
    return est, [h["loss"] for h in hist]


TE_TIERS = {"single": ({}, False), "chained": ({"steps_per_dispatch": 2},
                                                False),
            "device": ({"steps_per_dispatch": 2}, True)}


def _weights(est):
    return {n: p.detach().clone() for n, p in est.model.named_parameters()}


def _state(est):
    full = lambda t: t.gather() if isinstance(t, ShardedTensor) else t
    out = _weights(est)
    for k, v in est.opt_state.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": full(t).clone() for n, t in v.items()})
    return out


def _close(got, want, tol=TOL):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name], np.float32),
                                   np.asarray(w, np.float32), **tol,
                                   err_msg=name)


def _equal(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
@pytest.mark.parametrize("model", [1, 2], ids=["data4", "data4_model2"])
def test_the_step_matches_the_jax_estimator(model, zero):
    """At data 4, and at data 4 x model 2 with Megatron-placed weights,
    against the JAX estimator's data 4 x model 2 run on the 8-device mesh
    (f32 and SGD give the same trajectory whatever the placement), within
    1e-5.  Under the model axis the masters' and slots' bytes a position
    are the JAX run's, and beside them each data position holds a whole
    replica (the model axis saves no weight memory in this step)."""
    losses, weights, pbytes, obytes, steps = _jax_tiny(
        4, 2, shard_optimizer=zero)
    est, got = _run(4, model=model, shard_optimizer=zero)
    np.testing.assert_allclose(got, losses, **TOL)
    _close({n: t.numpy() for n, t in _weights(est).items()}, weights,
           dict(rtol=1e-5, atol=1e-5))
    assert est.global_step == steps == 8
    assert isinstance(est._pp, Positions) and est._pp.n == 4
    if model == 2:
        assert bytes_per_device(est.params) == pbytes
        assert bytes_per_device({k: v for k, v in est.opt_state.items()
                                 if k != "decayed"}) == obytes
        assert est.params["blk.attn.qkv.W"].sharding.spec == \
            P(None, "model")
        size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        whole = size(_weights(est).values())
        assert [size(est._pp._weights(i).values()) for i in range(4)] == \
            [whole] * 4
        assert pbytes < whole


def test_shard_model_false_runs_every_position_as_data():
    """A data 4 x model 2 mesh with ``shard_model=False``: the layers see
    data 8, and each of the 8 positions takes 2 rows of 16."""
    losses, weights, _, _, _ = _jax_tiny(4, 2, shard_optimizer=True)
    est, got = _run(0, ctx=_ctx(["cpu"] * 8, model=2),
                    shard_optimizer=True, shard_model=False)
    assert est._pp.n == 8
    np.testing.assert_allclose(got, losses, **TOL)
    _close({n: t.numpy() for n, t in _weights(est).items()}, weights,
           dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("case", [
    dict(opt="sgd"),
    dict(opt="adamw_bf16", mixed_precision=True, grad_dtype="bfloat16"),
    dict(opt="sgd", grad_accum_steps=2),
    dict(opt="lamb", tier="device"),
    dict(opt="adamw_bf16", mixed_precision=True, grad_dtype="bfloat16",
         model=2),
], ids=["sgd", "bench_update", "accum", "lamb_device_tier",
        "bench_update_model2"])
def test_zero_equals_the_step_without_it(case):
    """ZeRO against no ZeRO, dropout on: every element is updated once,
    by its owner, from the same sums in the same order, so weights and
    every slot agree to the bit (LAMB's leaf norms add their blocks'
    squares, which rounds otherwise than the whole leaf's norm: 1e-6)."""
    net = lambda: TinyTx(attn_drop=0.2)
    runs = [_run(4, net=net(), seed=5, epochs=1, shard_optimizer=zero,
                 **case) for zero in (False, True)]
    (plain, l0), (zero, l1) = runs
    if case["opt"] == "lamb":
        # a leaf's norm from its blocks' norms is not the whole leaf's to
        # the bit
        # the bit (and the qkv key bias's exact gradient is 0, which
        # LAMB's ratio turns into a full step: losses only, as the JAX
        # tests compare the Adam family)
        np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=0)
        return
    assert l0 == l1
    _equal(_state(zero), _state(plain))
    spec = zero.opt_state[next(k for k in zero.opt_state
                               if isinstance(zero.opt_state[k], dict))]
    assert spec["blk.attn.qkv.W"].sharding.spec == (
        P("data", "model") if case.get("model") else P("data", None))


@pytest.mark.parametrize("tier,kw", [
    ("single", {}), ("chained", {"gradient_clip_norm": 0.05}),
    ("device", {}), ("device", {"grad_accum_steps": 2}),
    ("single", {"grad_accum_steps": 2, "gradient_clip_norm": 0.05}),
    ("single", {"model": 2}), ("device", {"model": 2,
                                          "grad_accum_steps": 2})],
    ids=["single", "chained-clip", "device", "device-accum",
         "single-accum-clip", "model2", "model2-device-accum"])
def test_the_step_equals_todays_one_device_step(tier, kw):
    """The per-position step at data 4 (x model 2: each position's
    attention split over its row of model blocks) against today's step on
    the same mesh (one device, the whole batch): dropout on, so each
    position's draws must be its rows of the global masks (and its
    blocks' the JAX blocks')."""
    net = lambda: TinyTx(attn_drop=0.2)
    want, lw = _run(4, positions=False, tier=tier, net=net(), seed=7,
                    epochs=1, shard_optimizer=True, **kw)
    got, lg = _run(4, tier=tier, net=net(), seed=7, epochs=1,
                   shard_optimizer=True, **kw)
    np.testing.assert_allclose(lg, lw, **TOL)
    _close({n: t.numpy() for n, t in _weights(got).items()},
           {n: t.numpy() for n, t in _weights(want).items()},
           dict(rtol=1e-5, atol=1e-6))
    assert bytes_per_device(got.params) == bytes_per_device(want.params)


def test_each_positions_keep_masks_are_its_rows_of_the_global_masks():
    B, H, seed, n = 8, HEADS, 21, 4
    rows = B // n
    whole_hidden = _mask((B, T, D), seed, 0.1)
    whole_attn = TA._hash_keep_mask(seed, (B, H, T, T), 0.1)
    for i in range(n):
        with distributed.position_scope(i, n):
            hidden = _mask((rows, T, D), seed, 0.1,
                           offset=process_offset((rows, T, D)))
            attn = TA._hash_keep_mask(
                seed, (rows, H, T, T), 0.1,
                bh_offset=distributed.batch_offset(rows) * H)
        assert torch.equal(hidden, whole_hidden[i * rows:(i + 1) * rows])
        assert torch.equal(attn, whole_attn[i * rows:(i + 1) * rows])
    # outside a scope: the process's rule (process 0 of 1)
    assert distributed.batch_offset(rows) == 0


@pytest.mark.parametrize("batch", [16, 10], ids=["even", "ragged"])
def test_predict_and_evaluate_over_positions_equal_the_unsharded(batch):
    est, _ = _run(4, shard_optimizer=True)
    x, y = _tiny_data()
    fs = FeatureSet.from_ndarrays(x, y, shuffle=False)
    preds = est.predict(fs, batch_size=batch)
    scores = est.evaluate(fs, batch_size=batch)
    plain = Estimator(est.model, None, "mse", device="cpu")
    np.testing.assert_allclose(preds, plain.predict(fs, batch_size=batch),
                               rtol=0, atol=1e-6)
    assert preds.shape == (64, 1)
    assert scores["loss"] == pytest.approx(
        plain.evaluate(fs, batch_size=batch)["loss"], rel=1e-6)


@pytest.mark.parametrize("direction", ["positions_to_one", "one_to_positions"])
def test_checkpoints_cross_between_the_two_steps(tmp_path, direction):
    """A checkpoint of one step restores into the other and resumes as
    the uninterrupted run (SGD with momentum: the ZeRO-placed trace
    travels too)."""
    first, second = ((True, False) if direction == "positions_to_one"
                     else (False, True))
    whole, lw = _run(4, positions=first, epochs=2, shard_optimizer=True)
    ck = str(tmp_path)
    _run(4, positions=first, epochs=1, shard_optimizer=True,
         checkpoint_dir=ck)
    resumed, lr = _run(4, positions=second, epochs=2, shard_optimizer=True,
                       checkpoint_dir=ck, resume=True)
    assert resumed.global_step == whole.global_step == 8
    np.testing.assert_allclose(lr, lw[1:], **TOL)
    _close({n: t.numpy() for n, t in _state(resumed).items()},
           {n: t.numpy() for n, t in _state(whole).items()},
           dict(rtol=1e-5, atol=1e-6))


ALTERNATE = ["cpu", "meta"] * 2


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
@pytest.mark.parametrize("mixed,model", [(False, 1), (True, 1), (True, 2)],
                         ids=["f32", "bf16", "bf16_model2"])
def test_placement_on_alternating_devices(zero, mixed, model):
    """Data positions alternating ``cpu`` and ``meta`` build the
    per-position plan with no selector: each data position's replica
    (and bf16 shadow) lies on its device, each update block's master view
    and slots on its owner's, every master shard on its position's (under
    the model axis, the Megatron blocks), and the feed puts each
    position's rows there.  Nothing is computed."""
    layout = [d for d in ALTERNATE for _ in range(model)]
    ctx = _ctx(layout, model=model)
    assert ctx.distinct_devices
    net = TinyTx()
    est = Estimator(net, _opt(TO, "adamw_bf16"), "mse", ctx=ctx,
                    shard_optimizer=zero, mixed_precision=mixed,
                    grad_dtype="bfloat16" if mixed else None)
    assert est._per_position and est.device.type == "cpu"
    est._prepare(seed=0)
    pp = est._pp
    flat = [torch.device(d) for d in layout]
    devs = [torch.device(d) for d in ALTERNATE]
    assert [{t.device for t in r.values()} for r in pp.tensors] == \
        [{d} for d in devs]
    assert ([{t.device for t in r.values()} for r in pp.shadows]
            if mixed else pp.shadows) == ([{d} for d in devs] if mixed
                                          else None)
    for j, (_, _, owner) in enumerate(pp.entries):
        assert pp.ps[j].device == flat[owner]
        assert all(pp.slots[k][j].device == flat[owner] for k in pp.slots)
    owners = {owner for _, _, owner in pp.entries}
    assert owners == (set(range(4 * model)) if zero
                      else set(range(model)))
    for name, m in est.params.items():
        assert [t.device for t in m.shards] == flat, name
    assert est.params["blk.attn.qkv.W"].sharding.spec == (
        P(None, "model") if model == 2 else P())
    mu = est.opt_state["mu"]["blk.attn.qkv.W"]
    if zero:
        assert [t.device for t in mu.shards] == flat
        assert mu.sharding.spec == P("data", "model" if model == 2
                                     else None)
    x, y = _tiny_data(16)
    fs = FeatureSet.from_ndarrays(x, y, shuffle=False)
    xb, yb = next(fs.batches(16, ctx=ctx))
    assert [t.device for t in xb.shards] == flat
    assert [tuple(t.shape) for t in yb.shards] == [(4, 1)] * (4 * model)
    for i, dev in enumerate(devs):
        assert rows_of(xb, 4 * i, 4, dev).device == dev
    stacked = fs.cache_device().stacked_epoch(8, 0, None, ctx=ctx)
    assert [t.device for t in stacked[0].shards] == flat
    assert stacked[0].sharding.spec == P(None, "data")


def test_a_mesh_on_several_devices_over_a_sequence_axis_raises():
    """It raised until the per-position step took the sequence axis: the
    positions that differ only along it hold the same rows and replica,
    so the data positions are its first coordinate's (``cpu`` here), as
    do ZeRO's blocks, which the sequence axis does not split: each owned
    and held on its data position's device.  What still raises
    naming Queue 1 item 5 is a job the port does not split
    (``tests/test_torch_job_layouts.py``)."""
    mc = MeshConfig(data=2, sequence=2)
    ctx = tctx.ZooContext(ZooConfig(mesh=mc), tctx._build_mesh(
        [torch.device(d) for d in ALTERNATE], mc))
    est = Estimator(TinyTx(), TO.SGD(lr=0.05, momentum=0.9), "mse",
                    ctx=ctx, shard_optimizer=True)
    assert est._per_position
    est._prepare(seed=0)
    assert est._pp.positions == [0, 2]
    assert [d.type for d in est._pp.devs] == ["cpu", "cpu"]
    owners = {q for _, _, q in est._pp.entries}
    assert owners == {0, 2}
    trace = est.opt_state["trace"]["blk.attn.qkv.W"]
    assert trace.sharding.spec == P("data", None)
    assert [t.device.type for t in trace.shards] == ["cpu"] * 4
    assert trace.shards[0] is trace.shards[1]


def test_the_shard_manifest_feed_stages_each_positions_rows(tmp_path):
    x, y = _tiny_data(40)
    paths = write_npz_shards(str(tmp_path), x, y, num_shards=2)
    fs = ShardedFeatureSet(paths, shuffle=False, prefetch=0)
    ctx = _ctx(ALTERNATE)
    got = list(fs.batches(16, drop_remainder=False, ctx=ctx))
    assert len(got) == 3
    for xb, yb in got:
        assert [t.device for t in xb.shards] == [torch.device(d)
                                                 for d in ALTERNATE]
    # the ragged batch of 8 rows: 2 a position
    assert tuple(got[-1][1].shards[0].shape) == (2, 1)
    # on one device the feed is today's
    xb, _ = next(fs.batches(16, ctx=_ctx(["cpu"] * 4)))
    assert isinstance(xb, torch.Tensor)
    np.testing.assert_array_equal(
        got[0][0].shards[0].numpy(), xb[:4].numpy())


def test_ordered_reduction_and_broadcast():
    rs = np.random.RandomState(3)
    parts = [[torch.from_numpy(rs.randn(5).astype(np.float32))]
             for _ in range(4)]
    want = ((parts[0][0] + parts[1][0]) + parts[2][0]) + parts[3][0]
    got = reduce_ordered(parts, "cpu")[0]
    assert torch.equal(got, want)
    assert got.data_ptr() != parts[0][0].data_ptr()
    low = reduce_ordered([[p[0].bfloat16()] for p in parts], "cpu",
                         torch.float32)[0]
    assert low.dtype == torch.float32
    dsts = [torch.zeros(5) for _ in range(3)]
    broadcast_from(got, dsts + [got])
    assert all(torch.equal(d, got) for d in dsts)
    mesh = Mesh(["cpu", "meta"], ("data",))
    assert mesh.distinct_devices and mesh.stream(0) is None
    assert mesh.block_streams
    shared = Mesh(["cpu"] * 2, ("data",))
    assert not shared.distinct_devices and not shared.block_streams
    # a shared device runs a sharded op's blocks on its current stream
    assert shared.streams_at([{"data": 0}, {"data": 1}]) == [None, None]


def test_sharded_tensor_collectives_across_devices():
    """A replicated leaf held on two devices gathers from its first
    holder and scatters to both; a reduce-scatter adds on each shard's
    device."""
    from analytics_zoo_tpu_torch.parallel import NamedSharding
    mesh = Mesh(["cpu", "cpu"], ("data",))
    a, b = torch.arange(4.0), torch.full((4,), -1.0)
    st = ShardedTensor([a, b], (4,), NamedSharding(mesh, P()))
    assert torch.equal(st.gather(), a)
    st.scatter_(torch.ones(4) * 3)
    assert torch.equal(a, torch.full((4,), 3.0)) and torch.equal(a, b)
    z = ShardedTensor([torch.zeros(2), torch.zeros(2)], (4,),
                      NamedSharding(mesh, P("data")))
    z.reduce_scatter_(torch.arange(4.0), accumulate=True)
    assert torch.equal(z.gather(), torch.arange(4.0))
