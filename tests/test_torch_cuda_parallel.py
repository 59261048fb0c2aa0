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
2 with ZeRO equal to the unsharded one bit for bit.
"""

import numpy as np
import pytest
import torch

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


def _bert_run(dev, ctx, steps=4, batch=8, opt=None, **kw):
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
    torch.manual_seed(0)
    net = BERTClassifier(2, bert_config=BERT_SMALL, device=dev).net
    est = Estimator(net, opt or SGD(lr=0.05, momentum=0.9),
                    "sparse_categorical_crossentropy", ctx=ctx, device=dev,
                    **kw)
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
