"""Training over every process layout the JAX package accepts, on the CPU,
in one test process.

Each rank of a job is a thread with a ``torch.distributed.
ProcessGroupGloo`` over one ``HashStore`` and its own ``ZooContext``
(``_build_mesh(["cpu"] * k, mc, group)``: the mesh of every rank's k
positions, this rank's local), pinned with ``context_scope``; the
per-position step is reached through the estimator's private selector.
The layouts (ranks x positions a rank):

- data 4 as 2 x 2 (each rank two whole data rows);
- data 2 x model 2 as 2 x 2 (a model group inside a rank);
- data 2 x model 2 as 4 x 1 (model groups across ranks);
- data 1 x model 2 as 2 x 1 (one data coordinate, both ranks);
- data 2 x sequence 2 in one process of 4 positions.

Held, f32, SGD, dropout off, the tiny transformer of
``tests/test_torch_mesh_train.py`` from the JAX tree: losses and weights
against the JAX estimator on the 8-device CPU mesh of the same data,
model and sequence sizes (an ``expert`` axis fills the 8 devices: it only
shapes the mesh) within 1e-5, in the per-position step and in the
one-device step; ZeRO against the run without it, bit for bit;
``bytes_per_device`` against the JAX estimator's.  With dropout on, each
position's keep-masks are its data coordinate's rows of the JAX global
masks, bit for bit, equal in the ranks that share the coordinate, and a
job's trajectory with accumulation equals one process's over the same
mesh.  The feeds (arrays, the DEVICE tier, a shard manifest) give each
rank its data group's rows; a per-host checkpoint crosses between 4
ranks and one process of 4 positions both ways; LAMB and clipping by
the global norm take norms over blocks split across ranks; a layout the
port does not split raises naming ROADMAP Queue 1 item 5.  The JAX runs
are made once, in one module fixture.
"""

import contextlib
import datetime
import functools
import os
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import analytics_zoo_tpu_torch.estimator.estimator as TE
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common.config import ZooConfig as JZooConfig
from analytics_zoo_tpu.ops.attention import _hash_keep_mask as j_keep_mask
from analytics_zoo_tpu.ops.dropout import _mask as j_mask
from analytics_zoo_tpu.parallel import bytes_per_device as jbytes
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu_torch.data import FeatureSet
from analytics_zoo_tpu_torch.data.sharded import (ShardedFeatureSet,
                                                  assign_shards,
                                                  write_npz_shards)
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.estimator import checkpoint as TC
from analytics_zoo_tpu_torch.keras import optimizers as TO
from analytics_zoo_tpu_torch.ops import attention as TA
from analytics_zoo_tpu_torch.ops.dropout import _mask, process_offset
from analytics_zoo_tpu_torch.parallel import (ShardedTensor,
                                              bytes_per_device, distributed)
from test_torch_mesh_train import (D, HEADS, T, JEstimator, JFeatureSet,
                                   JO, JTinyTx, TinyTx, _flat, _opt,
                                   _tiny_data, _tiny_tree)

TOL = dict(rtol=1e-5, atol=1e-6)
_STORE = dist.HashStore()
_RUNS = iter(range(1 << 30))

#: name: (ranks, positions a rank, mesh axes)
LAYOUTS = {
    "data4_2x2": (2, 2, dict(data=4)),
    "data2_model2_2x2": (2, 2, dict(data=2, model=2)),
    "data2_model2_4x1": (4, 1, dict(data=2, model=2)),
    "data1_model2_2x1": (2, 1, dict(data=1, model=2)),
    "data2_sequence2_1x4": (1, 4, dict(data=2, sequence=2)),
}


@pytest.fixture(autouse=True, scope="module")
def _module_settings():
    """The JAX compile cache off (sharded programs revived from it
    corrupt this jaxlib's heap), one intra-op thread (the tensors are
    tiny and the ranks are threads)."""
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_compilation_cache", prev)


@pytest.fixture(autouse=True)
def _fresh_contexts():
    tctx.reset_context()
    yield
    tctx.reset_context()


def _mc(axes) -> MeshConfig:
    return MeshConfig(**{"data": 1, "model": 1, **axes})


def _ranks(fn, layout, positions=True, timeout=30.0):
    """``fn(rank, ctx)`` in each rank of ``layout`` (a thread each, one
    gloo group over a ``HashStore``; one rank runs with no group), its
    estimators made under the per-position selector when ``positions``;
    returns the results in rank order."""
    n, k, axes = LAYOUTS[layout] if isinstance(layout, str) else layout
    mc = _mc(axes)
    prefix = f"job{next(_RUNS)}"
    out, errors = [None] * n, []

    def body(rank):
        try:
            group = None
            if n > 1:
                pg = dist.ProcessGroupGloo(
                    dist.PrefixStore(prefix, _STORE), rank, n,
                    datetime.timedelta(seconds=timeout))
                group = distributed.Group(pg, rank, n, "gloo", timeout)
            ctx = tctx.ZooContext(ZooConfig(mesh=mc), tctx._build_mesh(
                [torch.device("cpu")] * k, mc, group))
            with tctx.context_scope(ctx):
                out[rank] = fn(rank, ctx)
        except BaseException as exc:           # re-raised on the caller
            errors.append(exc)
    # the selector is process-wide: set once around every rank's thread
    scope = (TE._positions_on_shared_devices() if positions
             else contextlib.nullcontext())
    with scope:
        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + 10)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    return out


def _fs(x=None, y=None):
    if x is None:
        x, y = _tiny_data()
    return FeatureSet.from_ndarrays(x, y, shuffle=False)


def _train(ctx, zero=False, opt="sgd", epochs=1, seed=None, **kw):
    """The tiny transformer from the JAX tree, ``epochs`` of 4 steps at
    global batch 16: epoch losses, weights, master and slot bytes a
    position, the estimator."""
    net = TinyTx()
    net.set_weights(_tiny_tree())
    est = Estimator(net, _opt(TO, opt), "mse", ctx=ctx,
                    shard_optimizer=zero, **kw)
    hist = est.train(_fs(), batch_size=16, epochs=epochs, seed=seed)
    weights = {n: p.detach().clone() for n, p in net.named_parameters()}
    slots = {k: v for k, v in est.opt_state.items() if k != "decayed"}
    return ([h["loss"] for h in hist], weights,
            (bytes_per_device(est.params), bytes_per_device(slots)), est)


def _jax_estimator(layout, zero, epochs):
    """The JAX estimator's ``epochs`` of 4 steps (0: its placement alone)
    on the 8-device CPU mesh of the layout's data, model and sequence
    sizes, ``expert`` filling the rest: losses, weights and bytes a
    device."""
    _, _, axes = LAYOUTS[layout]
    cfg = JZooConfig()
    for name, size in axes.items():
        setattr(cfg.mesh, name, size)
    cfg.mesh.model = axes.get("model", 1)
    cfg.mesh.expert = 8 // (axes["data"] * cfg.mesh.model
                            * axes.get("sequence", 1))
    ctx = jctx.ZooContext(cfg, jctx._build_mesh(list(jax.devices()[:8]),
                                                cfg.mesh))
    x, y = _tiny_data()
    est = JEstimator(JTinyTx(name="tiny"), _opt(JO, "sgd"), "mse", ctx=ctx,
                     shard_optimizer=zero)
    hist = est.train(JFeatureSet.from_ndarrays(x, y, shuffle=False),
                     batch_size=16, epochs=epochs,
                     variables=(_tiny_tree(), {}))
    return ([h["loss"] for h in hist], _flat(est.params),
            (jbytes(est.params), jbytes(est.opt_state)))


@pytest.fixture(scope="module")
def jax_runs():
    """Every layout's JAX run, made once for the module."""
    return {layout: _jax_estimator(layout, False, 1) for layout in LAYOUTS}


@functools.lru_cache(maxsize=None)
def _jax_zero_bytes(layout):
    """The JAX estimator's bytes a device under ZeRO (its placement)."""
    return _jax_estimator(layout, True, 0)[2]


@functools.lru_cache(maxsize=None)
def _port(layout, positions, zero=False):
    return _ranks(lambda r, ctx: _train(ctx, zero)[:3], layout, positions)


def _close(got, want, tol=TOL):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w),
                                   **tol, err_msg=name)


STEPS = ["positions", "one_device"]


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_the_layout_trains_as_the_jax_estimator(layout, step, jax_runs):
    """Every rank's epoch loss and weights after 4 steps against the JAX
    estimator's within 1e-5, and the ranks' weights equal (one
    all-reduced gradient)."""
    want_l, want_w, _ = jax_runs[layout]
    runs = _port(layout, step == "positions")
    for losses, weights, _ in runs:
        np.testing.assert_allclose(losses, want_l, **TOL)
        _close(weights, want_w)
    for _, weights, _ in runs[1:]:
        for name, w in runs[0][1].items():
            assert torch.equal(weights[name], w), name


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_zero_equals_the_run_without_it(layout, step, jax_runs):
    """ZeRO's update blocks take the same all-reduced gradient: the same
    bits as without it; each rank's master and slot bytes a position are
    the JAX estimator's (ZeRO's slots a quarter or less where the data
    axis splits them)."""
    plain = _port(layout, step == "positions")
    zero = _port(layout, step == "positions", True)
    want = _jax_zero_bytes(layout)
    _, _, want_plain = jax_runs[layout]
    for (zl, zw, zb), (pl, pw, pb) in zip(zero, plain):
        assert zl == pl
        for name, w in pw.items():
            assert torch.equal(zw[name], w), name
        assert zb == want and pb == want_plain
        if LAYOUTS[layout][2]["data"] > 1:
            assert zb[1] < pb[1]


@pytest.mark.parametrize("layout", ["data4_2x2", "data2_model2_4x1",
                                    "data1_model2_2x1"])
def test_masks_follow_the_data_coordinate(layout):
    """With dropout from one int seed, each position's hidden and
    attention keep-masks (drawn at ``batch_offset`` inside its
    ``position_scope``) are its data coordinate's rows of the JAX global
    masks, bit for bit, and a rank's masks outside a scope its rows;
    ranks sharing a coordinate draw equal masks."""
    B, H, seed, rate = 16, HEADS, 21, 0.1
    dsize = LAYOUTS[layout][2]["data"]
    per = B // dsize
    hidden = np.asarray(j_mask((B, T, D), seed, rate))
    attn = np.asarray(j_keep_mask(seed, (B, H, T, T), rate))

    def rank(r, ctx):
        coords = ctx.mesh.data_coords()
        out = []
        for i, c in enumerate(coords):
            with distributed.position_scope(i, len(coords)):
                out.append((c, _mask((per, T, D), seed, rate,
                                     offset=process_offset((per, T, D))),
                            TA._hash_keep_mask(
                                seed, (per, H, T, T), rate,
                                bh_offset=distributed.batch_offset(per) * H)))
        rows = per * len(coords)
        whole = _mask((rows, T, D), seed, rate,
                      offset=process_offset((rows, T, D)))
        return coords, out, whole
    got = _ranks(rank, layout)
    for coords, out, whole in got:
        for c, h, a in out:
            np.testing.assert_array_equal(h.numpy(),
                                          hidden[c * per:(c + 1) * per])
            np.testing.assert_array_equal(a.numpy(),
                                          attn[c * per:(c + 1) * per])
        first = coords[0] * per
        np.testing.assert_array_equal(
            whole.numpy(), hidden[first:first + per * len(coords)])
    by_coords = {}
    for coords, _, whole in got:
        prev = by_coords.setdefault(tuple(coords), whole)
        assert torch.equal(prev, whole)


@pytest.mark.parametrize("layout", ["data4_2x2", "data2_model2_4x1"])
def test_dropout_and_accumulation_equal_one_process(layout, jax_runs):
    """With dropout on and ``grad_accum_steps=2``, each rank takes its
    rows of every global microbatch at its data coordinate's offset: the
    job's losses and weights equal one process's over the same mesh
    (4 positions of the host), within 1e-5."""
    n, k, axes = LAYOUTS[layout]
    kw = dict(epochs=1, seed=7, grad_accum_steps=2)
    runs = _ranks(lambda r, ctx: _train_drop(ctx, **kw), layout)
    one = _ranks(lambda r, ctx: _train_drop(ctx, **kw),
                 (1, n * k, axes))[0]
    for losses, weights in runs:
        np.testing.assert_allclose(losses, one[0], **TOL)
        _close(weights, one[1])
    # dropout ran: the losses are not those of the run without it
    assert not np.allclose(one[0], jax_runs[layout][0], atol=1e-4)


def _train_drop(ctx, seed, epochs, **kw):
    """``_train`` of the model with attention dropout 0.1, seeded."""
    net = TinyTx(attn_drop=0.1)
    net.set_weights(_tiny_tree())
    est = Estimator(net, _opt(TO, "sgd"), "mse", ctx=ctx, **kw)
    hist = est.train(_fs(), batch_size=16, epochs=epochs, seed=seed)
    return ([h["loss"] for h in hist],
            {n: p.detach().clone() for n, p in net.named_parameters()})


@pytest.mark.parametrize("layout", ["data2_model2_4x1",
                                    "data1_model2_2x1"])
def test_norms_over_blocks_split_across_ranks(layout):
    """LAMB's trust ratios and clipping by the global norm add the
    squared norms of blocks that lie in other ranks (each block counted
    by its owner): a job's run against one process's over the same mesh,
    with ZeRO, 2e-6 (a leaf's norm summed from blocks in another
    order)."""
    n, k, axes = LAYOUTS[layout]
    kw = dict(zero=True, opt="lamb", epochs=1, gradient_clip_norm=0.05)
    runs = _ranks(lambda r, ctx: _train(ctx, **kw)[:2], layout)
    one = _ranks(lambda r, ctx: _train(ctx, **kw)[:2], (1, n * k, axes))[0]
    for losses, weights in runs:
        np.testing.assert_allclose(losses, one[0], rtol=1e-6, atol=0)
        _close(weights, one[1], dict(rtol=1e-6, atol=2e-6))


@pytest.mark.parametrize("layout", ["data4_2x2", "data2_model2_4x1",
                                    "data1_model2_2x1"])
def test_feeds_give_each_rank_its_data_groups_rows(layout, tmp_path):
    """Arrays, the DEVICE tier and a shard manifest: a rank takes rows
    ``[g * B/G, (g + 1) * B/G)`` of each global batch for data group g of
    G, the same rows as the ranks of its group, every row when the data
    axis is 1; the manifest's shards split by data group."""
    x = np.arange(48, dtype=np.float32).reshape(24, 2)
    y = np.arange(24, dtype=np.int32)
    fs = FeatureSet.from_ndarrays(x, y, shuffle=True, seed=5)
    whole = [b[1].numpy() for b in fs.batches(8, epoch=1)]
    paths = write_npz_shards(str(tmp_path), x, y, 6, prefix="s")

    def rank(r, ctx):
        g, groups = ctx.mesh.data_group()
        got = [b[1].numpy() for b in fs.batches(8, epoch=1, ctx=ctx)]
        dev = [b[1].numpy() for b in fs.cache_device().batches(
            8, epoch=1, ctx=ctx)]
        sharded = ShardedFeatureSet(paths, shuffle=False)
        shard_rows = [b[1].numpy() for b in sharded.batches(
            8, ctx=ctx, device="cpu")]
        return g, groups, got, dev, sharded._local, shard_rows
    out = _ranks(rank, layout)
    groups = {"data4_2x2": 2, "data2_model2_4x1": 2,
              "data1_model2_2x1": 1}[layout]
    for g, count, got, dev, local, shard_rows in out:
        assert count == groups
        lbs = 8 // count
        assert [a.tolist() for a in got] == [
            w[g * lbs:(g + 1) * lbs].tolist() for w in whole]
        assert len(dev) == 3 and all(len(d) == lbs for d in dev)
        assert local == assign_shards(6, g, count)
        assert all(len(b) == lbs for b in shard_rows)
    by_group = {}
    for g, _, got, dev, local, shard_rows in out:
        prev = by_group.setdefault(g, (got, dev, shard_rows))
        for a, b in zip(prev, (got, dev, shard_rows)):
            assert [t.tolist() for t in a] == [t.tolist() for t in b]


def _momentum(est):
    trace = est.opt_state["trace"]
    return {n: (t.gather() if isinstance(t, ShardedTensor) else t).clone()
            for n, t in trace.items()}


def test_a_per_host_checkpoint_crosses_between_a_job_and_one_process(
        tmp_path, monkeypatch):
    """A ZeRO checkpoint of data 2 x model 2 over 4 ranks of one position
    (the Megatron-placed masters and the slots span the ranks: each rank
    writes its host file) restores in one process of 4 positions, and a
    per-host checkpoint of that process restores in the 4 ranks: the
    weights and momentum equal the writer's."""
    layout = "data2_model2_4x1"
    n, k, axes = LAYOUTS[layout]
    sgd = lambda: TO.SGD(lr=0.05, momentum=0.9)
    save = TE.save_checkpoint
    monkeypatch.setattr(TE, "save_checkpoint",
                        lambda d, s, b, keep=3: save(d, s, b, keep=keep,
                                                     per_host=True))

    def run(ctx, ckdir, epochs, resume=False):
        net = TinyTx()
        net.set_weights(_tiny_tree())
        est = Estimator(net, sgd(), "mse", ctx=ctx, shard_optimizer=True,
                        checkpoint_dir=ckdir)
        est.train(_fs(), batch_size=16, epochs=epochs, resume=resume)
        return ({nm: p.detach().clone() for nm, p in net.named_parameters()},
                _momentum(est), est.global_step)
    job_dir, one_dir = str(tmp_path / "job"), str(tmp_path / "one")
    job = _ranks(lambda r, ctx: run(ctx, job_dir, 1), layout)
    ck = TC.latest_checkpoint(job_dir)
    assert sorted(f for f in os.listdir(ck) if f.startswith("shards.h")) \
        == [f"shards.h{r}.npz" for r in range(n)]
    one = _ranks(lambda r, ctx: run(ctx, job_dir, 1, resume=True),
                 (1, n * k, axes))[0]
    assert one[2] == 4
    for a, b in zip(one[:2], job[0][:2]):
        for name, t in b.items():
            assert torch.equal(a[name], t), name
    # the other way: one process writes per host, the 4 ranks restore
    wrote = _ranks(lambda r, ctx: run(ctx, one_dir, 1), (1, n * k, axes))[0]
    back = _ranks(lambda r, ctx: run(ctx, one_dir, 1, resume=True), layout)
    for got in back:
        assert got[2] == 4
        for a, b in zip(got[:2], wrote[:2]):
            for name, t in b.items():
                assert torch.equal(a[name], t), name


def test_mesh_data_groups_and_an_unsplit_layout_raises():
    """The mesh's data coordinates and groups for each layout, and a
    layout whose ranks share some data coordinates but not all (data 3 x
    model 2 over 2 ranks of 3 positions) raises naming Queue 1 item 5 in
    the estimator and the feed."""
    def facts(r, ctx):
        mesh = ctx.mesh
        return mesh.data_coords(), mesh.data_groups(), mesh.data_group()
    assert _ranks(facts, "data2_model2_4x1") == [
        ([0], [[0, 1], [2, 3]], (0, 2))] * 2 + [
        ([1], [[0, 1], [2, 3]], (1, 2))] * 2
    assert _ranks(facts, "data4_2x2") == [
        ([0, 1], [[0], [1]], (0, 2)), ([2, 3], [[0], [1]], (1, 2))]
    assert _ranks(facts, "data1_model2_2x1") == [
        ([0], [[0, 1]], (0, 1))] * 2
    assert _ranks(facts, "data2_sequence2_1x4") == [([0, 1], [[0]], (0, 1))]

    def irregular(r, ctx):
        assert ctx.mesh.data_coords() == ([0, 1] if r == 0 else [1, 2])
        with pytest.raises(NotImplementedError, match="item 5"):
            Estimator(TinyTx(), TO.SGD(lr=0.05), "mse", ctx=ctx)
        with pytest.raises(NotImplementedError, match="item 5"):
            next(_fs().batches(12, ctx=ctx))
        return True
    assert _ranks(irregular, (2, 3, dict(data=3, model=2))) == [True] * 2


def test_a_jax_per_host_checkpoint_of_the_layout_loads_in_a_job(tmp_path):
    """The JAX estimator's per-host ZeRO checkpoint of data 2 x model 2
    (its 8-device CPU mesh, ``expert`` filling it) restores in a job of 4
    ranks of one position: every rank's weights and momentum equal the
    JAX run's final ones."""
    import analytics_zoo_tpu.estimator.estimator as jest_mod
    ckdir = str(tmp_path / "jax")
    cfg = JZooConfig()
    cfg.mesh.data, cfg.mesh.model, cfg.mesh.expert = 2, 2, 2
    ctx = jctx.ZooContext(cfg, jctx._build_mesh(list(jax.devices()[:8]),
                                                cfg.mesh))
    save = jest_mod.save_checkpoint
    jest_mod.save_checkpoint = lambda d, s, b, keep=3: save(
        d, s, b, keep=keep, per_host=True)
    try:
        jest = JEstimator(JTinyTx(name="tiny"), JO.SGD(lr=0.05, momentum=0.9),
                          "mse", ctx=ctx, shard_optimizer=True,
                          checkpoint_dir=ckdir)
        x, y = _tiny_data()
        jest.train(JFeatureSet.from_ndarrays(x, y, shuffle=False),
                   batch_size=16, epochs=1, variables=(_tiny_tree(), {}))
    finally:
        jest_mod.save_checkpoint = save
    ck = TC.latest_checkpoint(ckdir)
    assert os.path.exists(os.path.join(ck, "shards.h0.npz"))
    want = _flat(jest.params)

    def rank(r, ctx):
        net = TinyTx()
        est = Estimator(net, TO.SGD(lr=0.05, momentum=0.9), "mse", ctx=ctx,
                        shard_optimizer=True, checkpoint_dir=ckdir)
        est.train(_fs(), batch_size=16, epochs=1, resume=True)
        return (est.global_step,
                {n: p.detach().numpy() for n, p in net.named_parameters()},
                _momentum(est))
    for step, weights, trace in _ranks(rank, "data2_model2_4x1"):
        assert step == 4
        _close(weights, want, dict(rtol=0, atol=0))
        assert set(trace) == set(weights)


@pytest.mark.parametrize("layout", ["data2_model2_4x1", "data4_2x2"])
def test_predict_and_evaluate_in_a_job(layout):
    """``predict`` and ``evaluate`` in every rank of a job (each computing
    the whole batch over its positions) equal the unsharded model's on
    the trained weights."""
    def rank(r, ctx):
        _, weights, _, est = _train(ctx, epochs=1)
        return (weights, est.predict(_fs(), batch_size=16),
                est.evaluate(_fs(), batch_size=16)["loss"])
    out = _ranks(rank, layout)
    net = TinyTx()
    net.load_state_dict(out[0][0])
    plain = Estimator(net, None, "mse", device="cpu")
    want = plain.predict(_fs(), batch_size=16)
    loss = plain.evaluate(_fs(), batch_size=16)["loss"]
    for _, preds, got in out:
        np.testing.assert_allclose(preds, want, rtol=0, atol=1e-6)
        assert abs(got - loss) <= 1e-6 * abs(loss)
