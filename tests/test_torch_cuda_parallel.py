"""The sharded paths on the card, through the kernels.

Marked ``cuda``: every test skips with a reason where no CUDA device is
visible.  On a machine with a card: ``python -m pytest --noconftest
tests/test_torch_cuda_parallel.py``.  Shards repeat the one card
(``Mesh(["cuda:0"] * n, ...)``).  Sharded paged decode and chunk at mp 2
and 4 launch the kernel once per shard and equal the unsharded kernel bit
for bit (each shard splits its keys as the whole call does), over placed
pools read in place (no copies); sharded flash attention at dp 2 x mp 2
launches once per block and equals the unsharded kernel bit for bit,
with its dropout keep-mask equal to the plain version's; the flash
kernels at ``bh_offset`` 0 equal a launch without one, and at an offset
give the rows of the larger launch (output, gradients and keep-mask) bit
for bit; a sharded
decoder LM serves the unsharded engine's tokens.  The estimator's sharded
step (a small BERT, f32, dropout off, SGD): data 2 x model 2 with the
ZeRO update, data 4 with ZeRO, two microbatches and K = 2 graph replays,
each against the unsharded step (losses 1e-5 relative, weights 1e-5 of
max|p|), the graph against eager bit for bit, with 4 + 4 kernel launches
a layer and step under the 2 x 2 mesh; the bench's update (AdamW with a
bf16 first moment, mixed precision, bf16 gradients) under data 2 x model
2 with ZeRO equal to the unsharded one bit for bit.  Per-position
streams: each kernel of those paths launched from a non-default stream
against its plain version; sharded flash attention with a stream per
block bit-identical (output and gradients) to its blocks launched one
after another; the per-position step over ``cuda:0 x 4`` (a stream a
position) against today's step on the same mesh, 4 times its launches,
and with ZeRO equal to itself without it bit for bit; and over data 2 x
model 2 (Megatron-placed weights, each data position's row of attention
blocks) against today's step, with today's launches.  Jobs of several
processes, as threads of gloo ranks over a ``HashStore`` on the one card:
data 4 as 2 ranks x 2 positions (the per-position step in each rank)
and data 1 x model 2 split across 2 ranks of one position (the one-device
step, every rank computing both model blocks), each against one
process's step over the same mesh, with ZeRO equal to the run without it
bit for bit.
"""

import contextlib
import datetime
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from analytics_zoo_tpu_torch.common.config import LLMServingConfig
from analytics_zoo_tpu_torch.llm import GenerationClient, LLMServing
from analytics_zoo_tpu_torch.models.generation import DecoderLM
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import attention as TA
from analytics_zoo_tpu_torch.ops import paged_attention as TPA
from analytics_zoo_tpu_torch.parallel import (
    Mesh, NamedSharding, PartitionSpec as P, device_put)
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sharded paths through the "
                    "kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pools(dev, P_, bs, Hkv, D, gen, dtype):
    return [torch.randn(P_, bs, Hkv, D, generator=gen).to(dev, dtype)
            for _ in range(2)]


def _placed(pool, mesh):
    return device_put(pool, NamedSharding(mesh, P(None, None, "model",
                                                  None)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mp", [2, 4])
def test_sharded_paged_decode_equals_the_unsharded_kernel(dev, mp, dtype):
    gen = torch.Generator().manual_seed(mp)
    B, H, D, P_, bs, nb = 32, 12, 64, 260, 16, 16
    q = torch.randn(B, H, D, generator=gen).to(dev, dtype)
    kp, vp = _pools(dev, P_, bs, H, D, gen, dtype)
    lengths = torch.randint(0, nb * bs + 1, (B,), generator=gen).to(
        dev, torch.int32)
    tables = torch.randint(1, P_, (B, nb), generator=gen).to(
        dev, torch.int32)
    whole = TPA.paged_decode_attention(q, kp, vp, lengths, tables)
    mesh = Mesh(["cuda:0"] * mp, ("model",))
    pk, pv = _placed(kp, mesh), _placed(vp, mesh)
    _kernels.reset_launches()
    got = TPA.sharded_paged_decode_attention(mesh, q, pk, pv, lengths,
                                             tables)
    torch.cuda.synchronize()
    assert _kernels.paged_decode.launches == mp
    assert _kernels.paged_decode.copies == 0
    assert torch.equal(got, whole)
    plain = TPA.paged_decode_attention(q, kp, vp, lengths, tables,
                                       backend="plain")
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - plain.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mp", [2, 4])
def test_sharded_paged_chunk_equals_the_unsharded_kernel(dev, mp, dtype):
    gen = torch.Generator().manual_seed(10 + mp)
    Tc, H, D, P_, bs, nb, start = 256, 12, 64, 80, 16, 48, 384
    q = torch.randn(Tc, H, D, generator=gen).to(dev, dtype)
    kp, vp = _pools(dev, P_, bs, H, D, gen, dtype)
    table = torch.randperm(P_ - 1, generator=gen)[:nb].add(1).to(
        dev, torch.int32)
    whole = TPA.paged_chunk_attention(q, kp, vp, table, start)
    mesh = Mesh(["cuda:0"] * mp, ("model",))
    _kernels.reset_launches()
    got = TPA.sharded_paged_chunk_attention(
        mesh, q, _placed(kp, mesh), _placed(vp, mesh), table, start)
    torch.cuda.synchronize()
    assert _kernels.paged_chunk.launches == mp
    assert _kernels.paged_chunk.copies == 0
    assert torch.equal(got, whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sharded_flash_equals_the_unsharded_kernel(dev, dtype):
    gen = torch.Generator().manual_seed(3)
    B, T, H, D = 8, 128, 12, 64
    qkv = torch.randn(B, T, 3 * H * D, generator=gen).to(dev, dtype)
    q, k, v = (t.view(B, T, H, D).transpose(1, 2)
               for t in qkv.split(H * D, dim=-1))      # fused-QKV views
    lens = torch.randint(1, T + 1, (B,), generator=gen)
    mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.int32)
    mesh = Mesh(np.full((2, 2), "cuda:0", dtype=object), ("data", "model"))
    whole = TA.flash_attention(q, k, v, padding_mask=mask)
    _kernels.reset_launches()
    got = TA.sharded_flash_attention(mesh, q, k, v, padding_mask=mask)
    torch.cuda.synchronize()
    assert _kernels.flash_fwd.launches == 4
    assert _kernels.flash_fwd.copies == 0
    assert torch.equal(got, whole)


def test_sharded_flash_dropout_mask_is_the_plain_versions(dev):
    B, H, T = 4, 4, 64
    q = torch.zeros(B, H, T, T, device=dev)
    v = torch.eye(T, device=dev).expand(B, H, T, T).contiguous()
    mesh = Mesh(np.full((2, 2), "cuda:0", dtype=object), ("data", "model"))
    kw = dict(dropout_rate=0.1, dropout_seed=1234)
    got = TA.sharded_flash_attention(mesh, q, q, v, **kw) > 0
    want = TA.sharded_flash_attention(mesh, q, q, v, backend="plain",
                                      **kw) > 0
    assert torch.equal(got, want)
    assert 0.8 < got.float().mean().item() < 0.98


def _drop_attention(q, k, v, g, mask, seed, bh_offset, backend=None):
    """Output and (dq, dk, dv) of attention with dropout 0.3."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = TA.flash_attention(q, k, v, padding_mask=mask, dropout_rate=0.3,
                           dropout_seed=seed, bh_offset=bh_offset,
                           backend=backend)
    o.backward(g)
    return (o.detach(),) + tuple(t.grad for t in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_bh_offset_zero_is_the_launch_without_one(dev, dtype):
    gen = torch.Generator().manual_seed(11)
    B, H, T, D = 4, 3, 128, 64
    q, k, v, g = (torch.randn(B, H, T, D, generator=gen).to(dev, dtype)
                  for _ in range(4))
    kw = dict(dropout_thresh=TA._dropout_thresh(0.3), keep_scale=1 / 0.7,
              seed=77)
    o0, lse0 = _kernels.flash_fwd(q, k, v, with_lse=True, **kw)
    o1, lse1 = _kernels.flash_fwd(q, k, v, with_lse=True, bh_offset=0, **kw)
    assert torch.equal(o0, o1) and torch.equal(lse0, lse1)
    d0 = _kernels.flash_bwd(q, k, v, o0, g, lse0, **kw)
    d1 = _kernels.flash_bwd(q, k, v, o0, g, lse0, bh_offset=0, **kw)
    assert all(torch.equal(a, b) for a, b in zip(d0, d1))
    # the kernels' keep-mask at offset 0 is the plain version's
    z = torch.zeros(B, H, T, T, device=dev)
    eye = torch.eye(T, device=dev).expand(B, H, T, T).contiguous()
    got = TA.flash_attention(z, z, eye, dropout_rate=0.3, dropout_seed=77)
    want = TA.flash_attention(z, z, eye, dropout_rate=0.3, dropout_seed=77,
                              backend="plain")
    assert torch.equal(got > 0, want > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_bh_offset_gives_the_rows_of_the_larger_call(dev, dtype):
    """Rows 2..3 of a batch of 4, launched alone at offset 2*H, equal those
    rows of the whole launch bit for bit (output and gradients), and the
    kernels' keep-mask equals the plain mask at the same offset."""
    gen = torch.Generator().manual_seed(12)
    B, H, T, D = 4, 3, 128, 64
    q, k, v, g = (torch.randn(B, H, T, D, generator=gen).to(dev, dtype)
                  for _ in range(4))
    lens = torch.randint(1, T + 1, (B,), generator=gen)
    mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.int32)
    whole = _drop_attention(q, k, v, g, mask, 9, 0)
    rows = slice(2, 4)
    part = _drop_attention(q[rows], k[rows], v[rows], g[rows], mask[rows],
                           9, 2 * H)
    for a, b in zip(part, whole):
        assert torch.equal(a, b[rows])
    z = torch.zeros(2, H, T, T, device=dev)
    eye = torch.eye(T, device=dev).expand(2, H, T, T).contiguous()
    kw = dict(dropout_rate=0.3, dropout_seed=9, bh_offset=2 * H)
    got = TA.flash_attention(z, z, eye, **kw) > 0
    want = TA._hash_keep_mask(9, (2, H, T, T), 0.3, dev, bh_offset=2 * H)
    assert torch.equal(got, want)
    assert not torch.equal(got, TA._hash_keep_mask(9, (2, H, T, T), 0.3,
                                                   dev))


def test_sharded_decoder_serves_the_unsharded_tokens(dev):
    def serve(model, mp):
        eng = LLMServing(model, LLMServingConfig(
            max_active=4, num_blocks=64, block_size=16, max_model_len=256,
            prefill_chunk_tokens=64, model_parallel=mp),
            broker=InMemoryBroker())
        cli = GenerationClient(broker=eng.broker)
        eng.start()
        try:
            for i, p in enumerate(prompts):
                cli.submit(f"r{i}", p, 8)
            return [[t for _, t in cli.stream_tokens(f"r{i}", timeout=120)]
                    for i in range(len(prompts))]
        finally:
            eng.stop()

    rs = np.random.default_rng(0)
    prompts = [rs.integers(0, 200, n) for n in (5, 70, 130)]
    model = DecoderLM(200, 256, 4, 2, 512, 512, device=dev)
    want = serve(model, 1)
    _kernels.reset_launches()
    got = serve(model.shard(Mesh(["cuda:0"] * 2, ("model",))), 2)
    assert got == want
    assert _kernels.paged_decode.launches > 0
    assert _kernels.paged_decode.launches % 4 == 0     # 2 layers x 2
    assert not any(w.copies for w in _kernels.KERNELS.values())


BERT_SMALL = dict(vocab=128, hidden_size=128, n_block=2, n_head=4,
                  seq_len=32, intermediate_size=256, hidden_drop=0.0,
                  attn_drop=0.0)


def _bert_run(dev, ctx, steps=4, batch=8, opt=None, lock=None, **kw):
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier, TFDataset
    rs = np.random.default_rng(3)
    T, n = BERT_SMALL["seq_len"], steps * batch
    ids = rs.integers(0, BERT_SMALL["vocab"], (n, T)).astype(np.int32)
    lens = rs.integers(T // 2, T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    ds = TFDataset.from_ndarrays(((ids, np.zeros_like(ids), mask),
                                  (ids[:, 0] % 2).astype(np.int32)),
                                 batch_size=batch, memory_type="DEVICE")
    with lock or contextlib.nullcontext():     # ranks share the seed
        torch.manual_seed(0)
        net = BERTClassifier(2, bert_config=BERT_SMALL, device=dev).net
    est = Estimator(net, opt or SGD(lr=0.05, momentum=0.9),
                    "sparse_categorical_crossentropy", ctx=ctx, device=dev,
                    **kw)
    if lock is None:            # ranks: the caller counts their launches
        _kernels.reset_launches()
    hist = est.train(ds.get_training_data(), batch, epochs=1)
    torch.cuda.synchronize()
    return (hist[-1]["loss"], {n: p.detach().clone()
                               for n, p in net.named_parameters()},
            _kernels.flash_fwd.launches, _kernels.flash_bwd.launches)


def _ctx(data, model):
    from analytics_zoo_tpu_torch.common.config import MeshConfig, ZooConfig
    from analytics_zoo_tpu_torch.common.context import (ZooContext,
                                                        _build_mesh)
    mc = MeshConfig(data=data, model=model)
    return ZooContext(ZooConfig(mesh=mc), _build_mesh(
        [torch.device("cuda", 0)] * (data * model), mc))


@pytest.mark.parametrize("mesh,kw", [
    ((2, 2), dict(shard_optimizer=True)),
    ((4, 1), dict(shard_optimizer=True)),
    ((2, 2), dict(shard_optimizer=True, grad_accum_steps=2)),
    ((2, 2), dict(shard_optimizer=True, steps_per_dispatch=2))],
    ids=["dp2mp2-zero", "dp4-zero", "accum2", "graph-k2"])
def test_sharded_bert_step_equals_the_unsharded_step(dev, mesh, kw):
    loss0, w0, fwd0, bwd0 = _bert_run(dev, None)
    loss, w, fwd, bwd = _bert_run(dev, _ctx(*mesh), **kw)
    assert abs(loss - loss0) <= 1e-5 * abs(loss0)
    for name, p in w0.items():
        assert (w[name] - p).abs().max() <= 1e-5 * p.abs().max(), name
    calls = BERT_SMALL["n_block"] * 4              # 2 layers, 4 steps
    assert (fwd0, bwd0) == (calls, calls)
    calls *= 4 if mesh == (2, 2) else 1   # data alone: unsharded attention
    calls *= kw.get("grad_accum_steps", 1)         # a forward a microbatch
    assert (fwd, bwd) == (calls, calls)
    assert not any(k.copies for k in _kernels.KERNELS.values())


def test_sharded_graph_replays_equal_eager_bit_for_bit(dev):
    eager = _bert_run(dev, _ctx(2, 2), shard_optimizer=True)
    graph = _bert_run(dev, _ctx(2, 2), shard_optimizer=True,
                      steps_per_dispatch=4)
    assert graph[0] == eager[0]
    for name, p in eager[1].items():
        assert torch.equal(graph[1][name], p), name
    assert graph[2:] == eager[2:]


def test_sharded_bf16_adamw_update_equals_unsharded(dev):
    from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay
    kw = dict(mixed_precision=True, grad_dtype="bfloat16",
              steps_per_dispatch=4)
    opt = lambda: AdamWeightDecay(lr=1e-3, state_dtype="bfloat16", total=4)
    loss0, w0, _, _ = _bert_run(dev, None, opt=opt(), **kw)
    loss, w, _, _ = _bert_run(dev, _ctx(2, 2), opt=opt(),
                              shard_optimizer=True, **kw)
    assert loss == loss0
    for name, p in w0.items():
        assert torch.equal(w[name], p), name


# --- per-position streams ---------------------------------------------------

def _side(dev):
    """A non-default stream of the card, waiting for the current one."""
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    return s


def _from_side(dev, fn):
    """``fn()`` launched from a side stream, then waited for."""
    s = _side(dev)
    with torch.cuda.stream(s):
        out = fn()
    torch.cuda.current_stream(dev).wait_stream(s)
    torch.cuda.synchronize()
    return out


def test_each_kernel_launches_from_a_side_stream(dev):
    """The six kernels of the per-position paths, each launched from a
    non-default stream (the wrappers take the current stream), against
    their plain versions at the f32 tolerances of the other card
    tests."""
    from analytics_zoo_tpu_torch.parallel.ring import _block_grads
    gen = torch.Generator().manual_seed(7)
    B, H, T, D = 4, 4, 128, 64
    q, k, v, go = (torch.randn(B, H, T, D, generator=gen).to(dev)
                   for _ in range(4))
    q.requires_grad_()
    k.requires_grad_()
    v.requires_grad_()
    _kernels.reset_launches()

    def fwd_bwd(backend):
        o = TA.flash_attention(q, k, v, backend=backend)
        return (o, *torch.autograd.grad(o, (q, k, v), go))
    got = _from_side(dev, lambda: fwd_bwd(None))
    want = fwd_bwd("plain")
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4
    o, lse = _from_side(dev, lambda: TA.flash_forward_with_lse(q.detach(),
                                                               k.detach(),
                                                               v.detach()))
    o_p, lse_p = TA.flash_forward_with_lse(q.detach(), k.detach(),
                                           v.detach(), backend="plain")
    assert (o - o_p).abs().max().item() <= 2e-5
    assert (lse - lse_p).abs().max().item() <= 1e-5 * max(
        1.0, lse_p.abs().max().item())
    delta = TA._row_delta(o_p, go)

    def grads(impl):
        acc = [torch.zeros(B, H, T, D, device=dev) for _ in range(3)]
        _block_grads(q.detach(), go, lse_p, delta, k.detach(), v.detach(),
                     None, D ** -0.5, *acc, impl=impl)
        return acc
    for g, w in zip(_from_side(dev, lambda: grads("cuda")), grads("plain")):
        assert (g - w).abs().max().item() <= 1e-4
    Bd, P_, bs, nb = 8, 40, 16, 8
    qd = torch.randn(Bd, H, D, generator=gen).to(dev)
    kp, vp = _pools(dev, P_, bs, H, D, gen, torch.float32)
    lengths = torch.randint(1, nb * bs + 1, (Bd,), generator=gen).to(
        dev, torch.int32)
    tables = torch.randint(1, P_, (Bd, nb), generator=gen).to(
        dev, torch.int32)
    dec = _from_side(dev, lambda: TPA.paged_decode_attention(
        qd, kp, vp, lengths, tables))
    assert (dec - TPA.paged_decode_attention(
        qd, kp, vp, lengths, tables, backend="plain")).abs().max() <= 2e-5
    qc = torch.randn(32, H, D, generator=gen).to(dev)
    table = torch.randperm(P_ - 1, generator=gen)[:nb].add(1).to(
        dev, torch.int32)
    ch = _from_side(dev, lambda: TPA.paged_chunk_attention(qc, kp, vp,
                                                           table, 64))
    assert (ch - TPA.paged_chunk_attention(qc, kp, vp, table, 64,
                                           backend="plain")
            ).abs().max() <= 2e-5
    launches = {n: w.launches for n, w in _kernels.KERNELS.items()}
    assert all(launches[n] >= 1 for n in (
        "flash_fwd", "flash_bwd", "flash_fwd_lse", "flash_bwd_lse",
        "paged_decode", "paged_chunk")), launches


def _serial_sharded_flash(mesh, q, k, v, mask):
    """Today's serial form: each (data, model) block launched in turn on
    the current stream, the outputs joined."""
    rows = []
    for qr, kr, vr, mr in zip(q.split(q.shape[0] // 2), k.split(
            k.shape[0] // 2), v.split(v.shape[0] // 2),
            mask.split(mask.shape[0] // 2)):
        hl = q.shape[1] // 2
        rows.append(torch.cat([TA.flash_attention(
            qr[:, h:h + hl], kr[:, h:h + hl], vr[:, h:h + hl],
            padding_mask=mr) for h in (0, hl)], dim=1))
    return torch.cat(rows)


class _BlockStreams(Mesh):
    """A mesh whose sharded ops take a stream a position although its
    positions share one card (as they do over several cards)."""
    block_streams = True


def test_sharded_flash_on_block_streams_equals_serial_launches(dev):
    gen = torch.Generator().manual_seed(4)
    B, T, H, D = 8, 128, 12, 64
    q, k, v, go = (torch.randn(B, H, T, D, generator=gen).to(dev)
                   for _ in range(4))
    lens = torch.randint(1, T + 1, (B,), generator=gen)
    mask = (torch.arange(T)[None] < lens[:, None]).to(dev, torch.int32)
    grid = np.full((2, 2), "cuda:0", dtype=object)
    # one card runs its blocks on the current stream; a mesh over several
    # cards takes a stream a position, forced here on one card
    assert Mesh(grid, ("data", "model")).streams_at(
        [{"data": 0}, {"data": 1}]) == [None, None]
    mesh = _BlockStreams(grid, ("data", "model"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = TA.sharded_flash_attention(mesh, *leaves, padding_mask=mask)
    got_g = torch.autograd.grad(got, leaves, go)
    assert len({mesh.stream(p) for p in range(4)}) == 4
    leaves2 = [t.clone().requires_grad_() for t in (q, k, v)]
    want = _serial_sharded_flash(mesh, *leaves2, mask)
    want_g = torch.autograd.grad(want, leaves2, go)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for g, w in zip(got_g, want_g):
        assert torch.equal(g, w)


def test_per_position_step_on_one_card_equals_todays_step(dev):
    """The per-position step over ``cuda:0 x 4`` (the private selector:
    four positions, four streams) against today's step on the same mesh,
    and ZeRO against no ZeRO to the bit."""
    from analytics_zoo_tpu_torch.estimator import estimator as TE
    loss0, w0, fwd0, bwd0 = _bert_run(dev, _ctx(4, 1), shard_optimizer=True)
    runs = []
    for zero in (True, False):
        with TE._positions_on_shared_devices():
            runs.append(_bert_run(dev, _ctx(4, 1), shard_optimizer=zero))
    loss, w, fwd, bwd = runs[0]
    assert abs(loss - loss0) <= 1e-5 * abs(loss0)
    for name, p in w0.items():
        assert (w[name] - p).abs().max() <= 1e-5 * p.abs().max(), name
    # a launch a layer, position and step: 4 positions of 2 rows
    assert (fwd, bwd) == (fwd0 * 4, bwd0 * 4)
    assert runs[1][0] == loss
    for name, p in runs[1][1].items():
        assert torch.equal(w[name], p), name


def test_per_position_step_over_a_model_axis_equals_todays_step(dev):
    """Data 2 x model 2 over ``cuda:0 x 4`` with Megatron-placed weights:
    each data position's attention runs its row of (data, model) blocks,
    each block on its position's stream; against today's step on the
    same mesh, with the launches of today's step."""
    from analytics_zoo_tpu_torch.estimator import estimator as TE
    loss0, w0, fwd0, bwd0 = _bert_run(dev, _ctx(2, 2), shard_optimizer=True)
    with TE._positions_on_shared_devices():
        loss, w, fwd, bwd = _bert_run(dev, _ctx(2, 2), shard_optimizer=True)
    assert abs(loss - loss0) <= 1e-5 * abs(loss0)
    for name, p in w0.items():
        assert (w[name] - p).abs().max() <= 1e-5 * p.abs().max(), name
    assert (fwd, bwd) == (fwd0, bwd0)


_STORE = dist.HashStore()
_JOBS = iter(range(1 << 30))


def _job(ranks, positions, mc, fn, timeout=120.0):
    """``fn(ctx, lock)`` in ``ranks`` threads, each a gloo rank over one
    ``HashStore`` with ``positions`` positions of ``cuda:0`` in a mesh of
    ``mc``; the results in rank order."""
    from analytics_zoo_tpu_torch.common.config import ZooConfig
    from analytics_zoo_tpu_torch.common.context import (ZooContext,
                                                        _build_mesh,
                                                        context_scope)
    from analytics_zoo_tpu_torch.parallel import distributed
    prefix, lock = f"cudajob{next(_JOBS)}", threading.Lock()
    out, errors = [None] * ranks, []

    def body(rank):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore(prefix, _STORE),
                                       rank, ranks,
                                       datetime.timedelta(seconds=timeout))
            group = distributed.Group(pg, rank, ranks, "gloo", timeout)
            ctx = ZooContext(ZooConfig(mesh=mc), _build_mesh(
                [torch.device("cuda", 0)] * positions, mc, group))
            with context_scope(ctx):
                out[rank] = fn(ctx, lock)
        except BaseException as exc:
            errors.append(exc)
    threads = [threading.Thread(target=body, args=(r,))
               for r in range(ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    return out


def _held_to(runs, loss0, w0):
    for loss, w, _, _ in runs:
        assert abs(loss - loss0) <= 1e-5 * abs(loss0)
        for name, p in w0.items():
            assert (w[name] - p).abs().max() <= 1e-5 * p.abs().max(), name


def test_two_processes_of_two_positions_train_as_one_process(dev):
    """Data 4 as 2 ranks x 2 positions of ``cuda:0``, the per-position
    step in each rank (the private selector), against one process's
    step over data 4: losses 1e-5 relative, weights 1e-5 of max|p|; a
    launch a layer, position and step; ZeRO equal to no ZeRO bit for
    bit."""
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.estimator import estimator as TE
    loss0, w0, fwd0, bwd0 = _bert_run(dev, _ctx(4, 1))
    runs = {}
    for zero in (False, True):
        with TE._positions_on_shared_devices():
            _kernels.reset_launches()
            runs[zero] = _job(2, 2, MeshConfig(data=4), lambda ctx, lock: (
                _bert_run(dev, ctx, lock=lock, shard_optimizer=zero)))
            launches = (_kernels.flash_fwd.launches,
                        _kernels.flash_bwd.launches)
        assert launches == (fwd0 * 4, bwd0 * 4)      # both ranks' counts
    _held_to(runs[False], loss0, w0)
    for (zl, zw, _, _), (pl, pw, _, _) in zip(runs[True], runs[False]):
        assert zl == pl
        for name, p in pw.items():
            assert torch.equal(zw[name], p), name


def test_a_model_group_split_across_two_processes(dev):
    """Data 1 x model 2 over 2 ranks of one position each (the one-device
    step: each rank computes both model blocks of every layer) against
    one process's data 1 x model 2 step, and both ranks' weights
    equal."""
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    loss0, w0, fwd0, bwd0 = _bert_run(dev, _ctx(1, 2))
    _kernels.reset_launches()
    runs = _job(2, 1, MeshConfig(data=1, model=2),
                lambda ctx, lock: _bert_run(dev, ctx, lock=lock))
    assert (_kernels.flash_fwd.launches,
            _kernels.flash_bwd.launches) == (fwd0 * 2, bwd0 * 2)
    _held_to(runs, loss0, w0)
    for name, p in runs[0][1].items():
        assert torch.equal(runs[1][1][name], p), name
