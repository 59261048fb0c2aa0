"""Training over several processes, on the CPU, in one test process.

Each "process" is a thread with a ``torch.distributed.ProcessGroupGloo``
over a shared ``HashStore`` and its own ``ZooContext`` (the mesh of both
ranks, this rank's position local), pinned with ``context_scope``: the
port's collectives, feeds, dropout offsets, ZeRO exchange and checkpoint
barriers run as they do between real processes, with no port and no
child (but for one ``RayContext`` worker).  Held, f32:

- a tiny ``BERTClassifier`` (2 blocks, hidden 32, 2 heads, T 8), global
  batch 8, SGD, dropout off, 3 steps over two ranks against the JAX
  estimator on the 8-device CPU mesh at data 2 (weights through
  ``interop``: ``load_weights``) and against the port's one-process
  ``data=2`` step: losses and weights 1e-5;
- with dropout on, each rank's rows of the training forward equal the JAX
  global forward's rows (1e-5), its hidden and attention keep-masks the
  rows of the global masks bit for bit;
- ``grad_accum_steps=2`` with dropout on over the two ranks against the
  port's one process at data 2 (each rank's rows of every global
  microbatch, drawn at its offset): losses and weights 1e-5;
- ZeRO over the two ranks (SGD with momentum, and LAMB, whose trust
  ratios take norms over leaves split across ranks) equal to the run
  without it;
- per-rank feeds, the shard assignment, the retry rule, the checkpoint
  writers and a two-rank checkpoint restored in one process, the health
  report's rank, and the dropout offsets themselves.
"""

import datetime
import os
import threading
import weakref

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common.config import ZooConfig as JZooConfig
from analytics_zoo_tpu.estimator import estimator as JE
from analytics_zoo_tpu.keras.optimizers import SGD as JSGD
from analytics_zoo_tpu.ops.attention import (
    _hash_keep_mask as j_keep_mask)
from analytics_zoo_tpu.ops.dropout import _mask as j_mask
from analytics_zoo_tpu.tfpark import TFDataset as JTFDataset
from analytics_zoo_tpu.tfpark.text_estimators import BERTClassifier as JBERT
from analytics_zoo_tpu_torch.common import context as tctx
from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
from analytics_zoo_tpu_torch.common.health import HealthMonitor
from analytics_zoo_tpu_torch.data import FeatureSet
from analytics_zoo_tpu_torch.data.sharded import (ShardedFeatureSet,
                                                  assign_shards,
                                                  write_npz_shards)
from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.estimator import checkpoint as ckpt
from analytics_zoo_tpu_torch.estimator import estimator as TE
from analytics_zoo_tpu_torch.keras.optimizers import LAMB, SGD
from analytics_zoo_tpu_torch.ops import attention as TA
from analytics_zoo_tpu_torch.ops.dropout import (_mask, hash_dropout,
                                                 process_offset)
from analytics_zoo_tpu_torch.orca import RayContext
from analytics_zoo_tpu_torch.parallel import distributed
from analytics_zoo_tpu_torch.parallel.zero import bytes_per_device
from analytics_zoo_tpu_torch.tfpark import BERTClassifier, TFDataset

import torch_mp_workers

CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=8,
           intermediate_size=64, hidden_drop=0.0, attn_drop=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)
_STORE = dist.HashStore()
_RUNS = iter(range(1 << 30))


@pytest.fixture(autouse=True)
def _fresh_contexts():
    tctx.reset_context()
    yield
    tctx.reset_context()


def _context(group):
    mc = MeshConfig(data=2)
    return tctx.ZooContext(ZooConfig(mesh=mc), tctx._build_mesh(
        [torch.device("cpu")], mc, group))


def _ranks(fn, n=2, timeout=20.0):
    """``fn(rank, ctx)`` in ``n`` threads, each the rank of one gloo group
    under its own context; returns the results in rank order."""
    prefix = f"run{next(_RUNS)}"
    out, errors = [None] * n, []

    def body(rank):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore(prefix, _STORE),
                                       rank, n,
                                       datetime.timedelta(seconds=timeout))
            group = distributed.Group(pg, rank, n, "gloo", timeout)
            ctx = _context(group)
            with tctx.context_scope(ctx):
                out[rank] = fn(rank, ctx)
        except BaseException as exc:           # re-raised on the caller
            errors.append(exc)
    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 10)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    return out


def _data(n=24, seed=0):
    rs = np.random.default_rng(seed)
    T = CFG["seq_len"]
    ids = rs.integers(1, CFG["vocab"], (n, T)).astype(np.int32)
    lens = rs.integers(3, T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    seg = (np.arange(T)[None] >= (lens // 2)[:, None]).astype(np.int32)
    return (ids * mask, seg, mask), (ids[:, 0] % 2).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


#: each estimator's per-step losses (both packages'), read in
#: ``_post_dispatch``
_LOSSES = weakref.WeakKeyDictionary()


def _spy(orig):
    def spy(est, n, k, lv, *a, **kw):
        _LOSSES.setdefault(est, []).extend(
            np.ravel(np.asarray(lv, dtype=np.float64)).tolist())
        return orig(est, n, k, lv, *a, **kw)
    return spy


@pytest.fixture(autouse=True)
def _record_losses(monkeypatch):
    monkeypatch.setattr(TE.Estimator, "_post_dispatch",
                        _spy(TE.Estimator._post_dispatch))


def _jax_train(bert_config=CFG, **kw):
    """The JAX estimator's 3 steps at data 2 on the 8-device CPU mesh (2 x
    4, weights replicated) from the initial tree: the tree, the losses and
    the final weights."""
    cfg = JZooConfig()
    cfg.mesh.data, cfg.mesh.model = 2, 4
    prev = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    jctx.set_context(jctx.ZooContext(cfg, jctx._build_mesh(
        list(jax.devices()[:8]), cfg.mesh)))
    try:
        jclf = JBERT(num_classes=2, bert_config=bert_config,
                     optimizer=JSGD(lr=0.05), shard_model=False, **kw)
        params, _ = jclf.net.build(jax.random.PRNGKey(4))
        start = jax.tree_util.tree_map(np.array, params)
        jclf._variables = (params, {})
        orig = JE.Estimator._post_dispatch
        JE.Estimator._post_dispatch = _spy(orig)
        try:
            jclf.train(JTFDataset.from_ndarrays(_data(), batch_size=8),
                       epochs=1)
        finally:
            JE.Estimator._post_dispatch = orig
        (losses,) = [v for k, v in _LOSSES.items()
                     if isinstance(k, JE.Estimator)]
        return start, losses, _flat(jax.tree_util.tree_map(
            np.asarray, jclf._variables[0]))
    finally:
        jctx.reset_context()
        jax.config.update("jax_enable_compilation_cache", prev)


@pytest.fixture(scope="module")
def jax_run():
    return _jax_train()


def _one_process():
    """One process's context over a data-2 mesh of two host positions."""
    mc = MeshConfig(data=2)
    return tctx.ZooContext(ZooConfig(mesh=mc), tctx._build_mesh(
        [torch.device("cpu")] * 2, mc))


def _port_train(start, opt=lambda: SGD(lr=0.05), bert_config=CFG, **kw):
    """One rank's (or one process's) 3 steps through
    ``BERTClassifier.train``: losses and final weights."""
    clf = BERTClassifier(2, bert_config=bert_config, optimizer=opt(),
                         device="cpu", **kw)
    clf.load_weights(start)
    clf.train(TFDataset.from_ndarrays(_data(), batch_size=8), epochs=1)
    est = clf._train_est
    return _LOSSES[est], _flat(clf.net.get_weights()[0]), est


def test_two_ranks_train_as_the_jax_estimator_at_data_2(jax_run):
    start, want_l, want_w = jax_run
    runs = _ranks(lambda r, ctx: _port_train(start)[:2])
    with tctx.context_scope(_one_process()):
        single_l, single_w, _ = _port_train(start)
    for losses, weights in runs + [(single_l, single_w)]:
        assert len(losses) == 3
        np.testing.assert_allclose(losses, want_l, **TOL)
        assert set(weights) == set(want_w)
        for name, w in want_w.items():
            np.testing.assert_allclose(weights[name], w, **TOL,
                                       err_msg=name)
    # both ranks end at the same weights (the all-reduced gradient)
    for name, w in runs[0][1].items():
        np.testing.assert_array_equal(runs[1][1][name], w)
    np.testing.assert_allclose(runs[0][0], single_l, **TOL)


def test_accumulation_with_dropout_takes_the_global_microbatches(jax_run):
    """``grad_accum_steps=2`` with dropout on: microbatch j is rows
    [4j, 4j+4) of the global batch of 8, each rank computing its 2 rows of
    it at its offset with microbatch j's seed, as the port's one process
    at data 2 does (whose masks are JAX's global masks; the trajectory is
    not held against JAX's, whose step draws from a PRNG key where the
    port's derives an int seed): losses and weights 1e-5."""
    cfg = dict(CFG, hidden_drop=0.1, attn_drop=0.1)
    start = jax_run[0]
    runs = _ranks(lambda r, ctx: _port_train(
        start, bert_config=cfg, grad_accum_steps=2)[:2])
    with tctx.context_scope(_one_process()):
        one_l, one_w, _ = _port_train(start, bert_config=cfg,
                                      grad_accum_steps=2)
    for losses, weights in runs:
        np.testing.assert_allclose(losses, one_l, **TOL)
        for name, w in one_w.items():
            np.testing.assert_allclose(weights[name], w, **TOL,
                                       err_msg=name)
    # dropout ran: the losses are not those of the run without it
    assert not np.allclose(one_l, jax_run[1], rtol=0, atol=1e-3)


def test_dropout_draws_each_ranks_rows_of_the_global_masks(jax_run):
    start = jax_run[0]
    cfg = dict(CFG, hidden_drop=0.1, attn_drop=0.1)
    jb = JBERT(num_classes=2, bert_config=cfg)
    x, _ = _data(8, seed=3)
    seed = 21
    want, _ = jb.net.apply(start, {}, x, training=True, rng=seed)
    want = np.asarray(want)
    B, T, D, H = 8, CFG["seq_len"], CFG["hidden_size"], CFG["n_head"]
    jhidden = np.asarray(j_mask((B, T, D), seed, 0.1))
    jattn = np.asarray(j_keep_mask(seed, (B, H, T, T), 0.1))

    def rank(r, ctx):
        clf = BERTClassifier(2, bert_config=cfg, device="cpu")
        clf.load_weights(start)
        clf.net.train()
        rows = slice(4 * r, 4 * r + 4)
        with torch.no_grad():
            got = clf.net([torch.from_numpy(a[rows]) for a in x], seed=seed)
        hidden = _mask((4, T, D), seed, 0.1, offset=process_offset(
            (4, T, D)))
        attn = TA._hash_keep_mask(seed, (4, H, T, T), 0.1,
                                  bh_offset=distributed.batch_offset(4) * H)
        return got.numpy(), hidden.numpy(), attn.numpy()
    for r, (got, hidden, attn) in enumerate(_ranks(rank)):
        rows = slice(4 * r, 4 * r + 4)
        np.testing.assert_allclose(got, want[rows], **TOL)
        np.testing.assert_array_equal(hidden, jhidden[rows])
        np.testing.assert_array_equal(attn, jattn[rows])
    # dropout ran: the eval forward differs
    eval_out = np.asarray(jb.net.apply(start, {}, x, training=False)[0])
    assert not np.allclose(eval_out, want, atol=1e-3)


@pytest.mark.parametrize("opt", ["sgd_momentum", "lamb"])
def test_zero_over_two_ranks_equals_the_run_without_it(jax_run, opt):
    """ZeRO over the ranks against the ranks without it (SGD's update is
    elementwise on the same all-reduced gradient: the same bits) and
    against one process's ZeRO over data 2 (its whole-batch gradient sums
    in another order: 1e-6).  Adam's step turns any rounding of a key
    bias's zero gradient, or of LAMB's leaf norms (summed from blocks over
    the ranks), into up to 1e-6 on those elements, as between the
    one-process ZeRO and replicated runs, so LAMB compares at 2e-6."""
    start = jax_run[0]
    make = {"sgd_momentum": lambda: SGD(lr=0.05, momentum=0.9),
            "lamb": lambda: LAMB(lr=0.01)}[opt]
    sgd = opt == "sgd_momentum"
    tol = dict(rtol=0, atol=0) if sgd else dict(rtol=1e-6, atol=2e-6)
    tol_one = dict(rtol=1e-6, atol=1e-7) if sgd else tol

    def rank(r, ctx, zero):
        losses, weights, est = _port_train(start, make,
                                           shard_optimizer=zero)
        slots = {k: v for k, v in est.opt_state.items() if k != "decayed"}
        return losses, weights, bytes_per_device(slots)
    plain = _ranks(lambda r, ctx: rank(r, ctx, False))
    zero = _ranks(lambda r, ctx: rank(r, ctx, True))
    with tctx.context_scope(_one_process()):
        one_l, one_w, _ = _port_train(start, make, shard_optimizer=True)
    for (zl, zw, zb), (pl, pw, pb) in zip(zero, plain):
        np.testing.assert_allclose(zl, pl, rtol=1e-6, atol=0)
        np.testing.assert_allclose(zl, one_l, rtol=1e-6, atol=0)
        for name, w in pw.items():
            np.testing.assert_allclose(zw[name], w, **tol, err_msg=name)
            np.testing.assert_allclose(zw[name], one_w[name], **tol_one,
                                       err_msg=name)
        assert zb < pb            # each rank holds about half the slots
    for name, w in zero[0][1].items():
        np.testing.assert_array_equal(zero[1][1][name], w)


def test_feeds_split_each_global_batch_by_rank(tmp_path):
    x = np.arange(48, dtype=np.float32).reshape(24, 2)
    y = np.arange(24, dtype=np.int32)
    fs = FeatureSet.from_ndarrays(x, y, shuffle=True, seed=5)
    whole = [b[1].numpy() for b in fs.batches(8, epoch=1)]
    paths = write_npz_shards(str(tmp_path), x, y, 6, prefix="s")

    def rank(r, ctx):
        got = [b[1].numpy() for b in fs.batches(8, epoch=1, ctx=ctx)]
        dev = [b[1].numpy() for b in fs.cache_device().batches(
            8, epoch=1, ctx=ctx)]
        with pytest.raises(ValueError, match="multiple of the data"):
            next(fs.batches(9, ctx=ctx))
        sharded = ShardedFeatureSet(paths, shuffle=False)
        with pytest.raises(ValueError, match="process count 2"):
            sharded.steps_per_epoch(9)
        return got, dev, sharded._local, sharded.steps_per_epoch(8)
    out = _ranks(rank)
    for r, (got, dev, local, steps) in enumerate(out):
        assert [g.tolist() for g in got] == [
            w[4 * r:4 * r + 4].tolist() for w in whole]
        assert len(dev) == 3 and all(len(d) == 4 for d in dev)
        assert local == assign_shards(6, r, 2) and steps == 3
    # the DEVICE tier's ranks together feed its one-process batches
    one = [b[1].numpy().tolist() for b in fs.cache_device().batches(8, 1)]
    assert [a.tolist() + b.tolist() for a, b in zip(out[0][1], out[1][1])] \
        == one
    cover = sorted(assign_shards(7, 0, 2) + assign_shards(7, 1, 2))
    assert cover == list(range(7))


class _Failing(FeatureSet):
    """Fails at the second batch of an epoch, in every rank."""

    def batches(self, *a, **kw):
        for i, b in enumerate(super().batches(*a, **kw)):
            if i == 1:
                raise RuntimeError("injected feed failure")
            yield b


def test_a_failure_reraises_instead_of_retrying_in_place(tmp_path):
    x, y = _data(16)

    def rank(r, ctx):
        clf = BERTClassifier(2, bert_config=CFG, optimizer=SGD(lr=0.05),
                             device="cpu")
        est = Estimator(clf.net, SGD(lr=0.05),
                        "sparse_categorical_crossentropy",
                        checkpoint_dir=str(tmp_path / "ck"))
        assert est.retry_times > 0
        with pytest.raises(RuntimeError, match="injected feed failure"):
            est.train(_Failing(list(x), y, shuffle=False), 8, epochs=2)
        return est.global_step
    assert _ranks(rank) == [1, 1]


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
def test_checkpoint_writers_and_a_restore_in_one_process(tmp_path, zero,
                                                         jax_run):
    start = jax_run[0]
    ckdir = str(tmp_path / "ck")

    def rank(r, ctx):
        clf = BERTClassifier(2, bert_config=CFG,
                             optimizer=SGD(lr=0.05, momentum=0.9),
                             model_dir=ckdir, shard_optimizer=zero,
                             device="cpu")
        clf.load_weights(start)
        clf.train(TFDataset.from_ndarrays(_data(), batch_size=8), epochs=1)
        return _flat(clf.net.get_weights()[0])
    weights = _ranks(rank)
    ck = ckpt.latest_checkpoint(ckdir)
    files = sorted(os.listdir(ck))
    hosts = [f for f in files if f.startswith("shards.h")]
    assert hosts == (["shards.h0.npz", "shards.h1.npz"] if zero else [])
    (params, opt, _, meta), step = ckpt.restore_checkpoint(ck)
    assert step == 3 and meta["epoch"] == 1
    for name, w in weights[0].items():
        np.testing.assert_array_equal(params[name].numpy(), w)
    # one process resumes the two ranks' checkpoint, slots and all
    with tctx.context_scope(_one_process()):
        clf = BERTClassifier(2, bert_config=CFG,
                             optimizer=SGD(lr=0.05, momentum=0.9),
                             model_dir=ckdir, shard_optimizer=zero,
                             device="cpu")
        est = Estimator(clf.net, SGD(lr=0.05, momentum=0.9),
                        "sparse_categorical_crossentropy",
                        checkpoint_dir=ckdir, shard_optimizer=zero)
        est.train(FeatureSet.from_ndarrays(*_data(), shuffle=False), 8,
                  epochs=1, resume=True)
    assert est.global_step == 3
    got = _flat(clf.net.get_weights()[0])
    for name, w in weights[0].items():
        np.testing.assert_array_equal(got[name], w)
    trace = opt["trace"]
    for name, t in est.opt_state["trace"].items():
        full = t.gather() if hasattr(t, "gather") else t
        np.testing.assert_array_equal(full.numpy(), trace[name].numpy())


def test_group_collectives_and_sharded_tensors_across_ranks():
    from analytics_zoo_tpu_torch.parallel import (NamedSharding,
                                                  PartitionSpec as P,
                                                  device_put)

    def rank(r, ctx):
        g = ctx.group
        t = torch.tensor([r + 1.0, 2.0])
        g.all_reduce(t, "mean")
        b = g.broadcast(torch.tensor([float(r)]), src=1)
        g.barrier("t")
        got = distributed.process_allgather({"x": np.float32(r)})["x"]
        # a tensor split over the ranks' data positions: each holds its
        # half; the gather, the reduce-scatter and the scatter
        x = torch.arange(8.0).reshape(4, 2)
        st = device_put(x.clone(), NamedSharding(ctx.mesh, P("data")))
        local = [sl for sl, _ in st.unique_shards()]
        whole = st.gather()
        st.reduce_scatter_(torch.full((4, 2), float(r + 1)))
        summed = st.local_shard.clone()
        st.scatter_(x)
        return (t.tolist(), b.tolist(), got.tolist(),
                [(s0.start, s0.stop) for s0, _ in local], whole.tolist(),
                summed.tolist(), torch.equal(st.gather(), x),
                g.reduced_bytes)
    out = _ranks(rank)
    for r, (t, b, got, local, whole, summed, back, nbytes) in \
            enumerate(out):
        assert t == [1.5, 2.0] and b == [1.0]
        assert got == [0.0, 1.0]
        assert local == [(2 * r, 2 * r + 2)]
        assert whole == torch.arange(8.0).reshape(4, 2).tolist()
        assert summed == [[3.0, 3.0]] * 2 and back
        assert nbytes > 0


def test_health_reports_the_rank():
    out = _ranks(lambda r, ctx: HealthMonitor(device="cpu").probe_once())
    assert [s["process_index"] for s in out] == [0, 1]
    assert all(s["healthy"] for s in out)


def test_offsets_draw_slices_of_the_whole_mask():
    whole = _mask((6, 5, 4), 3, 0.3)
    assert torch.equal(_mask((2, 5, 4), 3, 0.3, offset=80), whole[4:])
    x = torch.ones(6, 5, 4)
    assert torch.equal(hash_dropout(x[4:], 0.3, seed=3, offset=80),
                       hash_dropout(x, 0.3, seed=3)[4:])
    keep = TA._hash_keep_mask(5, (4, 3, 8, 8), 0.2)
    assert torch.equal(TA._hash_keep_mask(5, (2, 3, 8, 8), 0.2,
                                          bh_offset=6), keep[2:])
    # offset 0 is the mask without one, and one process draws at 0
    assert torch.equal(_mask((6, 5, 4), 3, 0.3, offset=0), whole)
    assert process_offset((6, 5, 4)) == 0
    offsets = _ranks(lambda r, ctx: (process_offset((3, 5)),
                                     distributed.batch_offset(3)))
    assert offsets == [(0, 0), (15, 3)]


def test_ray_context_runs_one_cpu_worker():
    rc = RayContext(num_workers=1, platform="cpu").init()
    try:
        out = rc.run(torch_mp_workers.context_facts, args=(10,), timeout=60)
    finally:
        rc.stop()
    assert out == [(0, 1, "cpu", 10)]
