"""The sharded paths on the card, through the kernels.

Marked ``cuda``: every test skips with a reason where no CUDA device is
visible.  On a machine with a card: ``python -m pytest --noconftest
tests/test_torch_cuda_parallel.py``.  Shards repeat the one card
(``Mesh(["cuda:0"] * n, ...)``).  Sharded paged decode and chunk at mp 2
and 4 launch the kernel once per shard and equal the unsharded kernel bit
for bit (each shard splits its keys as the whole call does), over placed
pools read in place (no copies); sharded flash attention at dp 2 x mp 2
launches once per block and equals the unsharded kernel bit for bit,
with its dropout keep-mask equal to the plain version's; a sharded
decoder LM serves the unsharded engine's tokens.
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
