"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips with a reason where no CUDA device is
visible (the kernels have no CPU or interpret mode).  On a machine with
an H100 and nvcc: ``python -m pytest tests/test_torch_cuda_kernels.py``.
Forward tolerances: f32 2e-5 absolute (accumulation order), bf16 2e-2
absolute plus 2**-7 relative (two bf16 ulps of the output).  Backward:
f32 1e-4 * max(1, max|ref|) (summation order through five products),
bf16 2e-2 absolute plus 2**-6 relative (Z and dS are rounded to bf16
before their products, at places the two versions order differently).
The paged decode and chunk kernels take the forward's tolerances, and so
does ``flash_fwd_lse`` for its output; its log-sum-exp, f32 in both
versions, is held to 1e-5 * max(1, |lse|).  Ring attention on four shards
of one card: the output against the ring with plain blocks to 2e-5, the
gradients to 1e-4 * max(1, max|ref|).  ``flash_bwd_lse`` (one ring block
of the backward, added into f32 accumulators) takes the backward's
tolerances against the plain ``_block_grads``.
"""

import os
import subprocess

import pytest
import torch

from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops.attention import (
    _hash_keep_mask, _reference_attention, _reference_attention_bwd,
    _reference_attention_with_lse, _row_delta, _valid, flash_attention,
    flash_forward_with_lse)
from analytics_zoo_tpu_torch.ops.paged_attention import (
    paged_chunk_attention, paged_decode_attention)
from analytics_zoo_tpu_torch.parallel import Mesh, ring_attention
from analytics_zoo_tpu_torch.parallel.ring import _block_grads

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernel has "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return (2e-5, 0.0) if dtype == torch.float32 else (2e-2, 2.0 ** -7)


def _case(dev, dtype, B, H, Tq, Tk, D, mask=False, seed=0, **kw):
    g = torch.Generator().manual_seed(seed)
    mk = lambda T: torch.randn(B, H, T, D, generator=g).to(dev, dtype)
    q, k, v = mk(Tq), mk(Tk), mk(Tk)
    pm = None
    if mask:
        lens = torch.randint(1, Tk + 1, (B,), generator=g)
        lens[0] = 0                                  # a fully masked row
        pm = (torch.arange(Tk)[None] < lens[:, None]).int().to(dev)
    out = flash_attention(q, k, v, padding_mask=pm, **kw)
    ref = flash_attention(q, k, v, padding_mask=pm, backend="plain", **kw)
    torch.cuda.synchronize()
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(B=4, H=12, Tq=128, Tk=128, D=64, mask=True),
    dict(B=2, H=3, Tq=100, Tk=128, D=64, causal=True),
    dict(B=2, H=3, Tq=77, Tk=50, D=32, causal=True),
    dict(B=3, H=2, Tq=45, Tk=97, D=128, mask=True, causal=True,
         dropout_rate=0.2, dropout_seed=-7),
    dict(B=2, H=3, Tq=1, Tk=200, D=64, mask=True),
    dict(B=2, H=3, Tq=63, Tk=63, D=32, causal=True),
    dict(B=2, H=3, Tq=129, Tk=300, D=128, mask=True, dropout_rate=0.1,
         dropout_seed=11),
    dict(B=2, H=3, Tq=129, Tk=129, D=32, causal=True, dropout_rate=0.1,
         dropout_seed=12),
], ids=["mask", "causal_tq_lt_tk", "causal_tq_gt_tk", "ragged_d128",
        "tq1", "tq63_d32", "tq129_d128", "tq129_d32"])
def test_kernel_matches_plain(dev, dtype, case):
    before = _kernels.flash_fwd.launches
    out = _case(dev, dtype, **case)
    assert out.dtype == dtype
    assert _kernels.flash_fwd.launches == before + 1


def test_keep_mask_bit_identical(dev):
    B, H, T, D, p, seed = 2, 3, 128, 64, 0.1, 1234
    q = torch.zeros(B, H, T, D, device=dev)
    keep = torch.empty(B, H, T, T, dtype=torch.bool, device=dev)
    idx = torch.arange(D, device=dev)
    for half in range(T // D):
        v = torch.zeros(B, H, T, D, device=dev)
        v[:, :, half * D + idx, idx] = 1.0       # V row j = one-hot(j)
        o = flash_attention(q, q, v, dropout_rate=p, dropout_seed=seed)
        keep[..., half * D:(half + 1) * D] = o > 0
    assert torch.equal(keep, _hash_keep_mask(seed, (B, H, T, T), p,
                                             device=dev))


def test_strided_head_views_and_bad_head_dim(dev):
    B, T, H, D = 2, 40, 4, 64
    qkv = torch.randn(B, T, 3 * H * D, device=dev)
    q, k, v = (t.view(B, T, H, D).transpose(1, 2)
               for t in qkv.split(H * D, -1))
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention(q, k, v, backend="plain"),
                               atol=2e-5, rtol=0)
    bad = torch.randn(1, 1, 8, 48, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(bad, bad, bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_view_is_copied_and_right(dev, dtype):
    """A view 2 bytes off a 16-byte boundary (and one with a row stride
    that is no multiple of 16 bytes) is copied first, counted in
    ``copies``, and the result still matches the plain version; aligned
    head views are read in place."""
    B, H, T, D = 2, 3, 70, 64
    g = torch.Generator().manual_seed(8)
    buf = torch.randn(B * H * T * D + 1, generator=g).to(dev, dtype)
    q = buf[1:].view(B, H, T, D)
    k = torch.randn(B, H, T, D + 2, generator=g).to(dev, dtype)[..., :D]
    v = torch.randn(B, H, T, D, generator=g).to(dev, dtype)
    atol, rtol = _tol(dtype)
    for fwd in (flash_attention, flash_forward_with_lse):
        wrapper = (_kernels.flash_fwd if fwd is flash_attention
                   else _kernels.flash_fwd_lse)
        before = wrapper.copies
        out = fwd(q, k, v)
        ref = fwd(q, k, v, backend="plain")
        torch.cuda.synchronize()
        out, ref = (out, ref) if fwd is flash_attention else (out[0],
                                                              ref[0])
        assert wrapper.copies == before + 2           # q and k
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
        before = wrapper.copies
        fwd(v, v, v)
        assert wrapper.copies == before


def _bwd_case(dev, dtype, B, H, Tq, Tk, D, mask=False, seed=0, **kw):
    """(kernel grads, plain grads, inputs) for one case."""
    g = torch.Generator().manual_seed(seed)
    mk = lambda T: torch.randn(B, H, T, D, generator=g).to(dev, dtype)
    q, k, v, go = mk(Tq), mk(Tk), mk(Tk), mk(Tq)
    pm = None
    if mask:
        lens = torch.randint(1, Tk + 1, (B,), generator=g)
        lens[0] = 0                                  # a fully masked row
        pm = (torch.arange(Tk)[None] < lens[:, None]).int().to(dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, padding_mask=pm, **kw)
    got = torch.autograd.grad(o, leaves, go)
    ref = _reference_attention_bwd(
        q, k, v, o.detach(), go, pm, kw.get("causal", False), None,
        kw.get("dropout_rate", 0.0), kw.get("dropout_seed"))
    torch.cuda.synchronize()
    return got, ref, (q, k, v, go, pm)


def _assert_grads_close(got, ref, dtype):
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape, name
        if dtype == torch.float32:
            atol = 1e-4 * max(1.0, b.abs().max().item())
            torch.testing.assert_close(a, b, atol=atol, rtol=0, msg=name)
        else:
            torch.testing.assert_close(a.float(), b.float(), atol=2e-2,
                                       rtol=2.0 ** -6, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(B=4, H=12, Tq=128, Tk=128, D=64, mask=True),
    dict(B=2, H=3, Tq=100, Tk=128, D=64, causal=True),
    dict(B=2, H=3, Tq=77, Tk=50, D=32, causal=True),
    dict(B=3, H=2, Tq=45, Tk=97, D=128, mask=True, causal=True,
         dropout_rate=0.2, dropout_seed=-7),
    dict(B=4, H=3, Tq=128, Tk=128, D=64, mask=True, dropout_rate=0.1,
         dropout_seed=1234),
    dict(B=2, H=2, Tq=64, Tk=1024, D=64, mask=True),
], ids=["mask", "causal_tq_lt_tk", "causal_tq_gt_tk_d32",
        "dropout_d128", "dropout", "long_k"])
def test_bwd_kernel_matches_plain(dev, dtype, case):
    before = (_kernels.flash_fwd.launches, _kernels.flash_bwd.launches)
    got, ref, _ = _bwd_case(dev, dtype, **case)
    _assert_grads_close(got, ref, dtype)
    assert (_kernels.flash_fwd.launches, _kernels.flash_bwd.launches) == (
        before[0] + 1, before[1] + 1)


def test_bwd_kernel_repeats_bit_identical(dev):
    case = dict(B=4, H=3, Tq=128, Tk=128, D=64, mask=True, dropout_rate=0.1,
                dropout_seed=99)
    first, _, _ = _bwd_case(dev, torch.float32, **case)
    again, _, _ = _bwd_case(dev, torch.float32, **case)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_bwd_kernel_matches_autograd_of_the_plain_forward(dev):
    # an independent derivation: torch autograd through the plain forward
    case = dict(B=2, H=4, Tq=96, Tk=80, D=64, mask=True, causal=True,
                dropout_rate=0.15, dropout_seed=5)
    got, _, (q, k, v, go, pm) = _bwd_case(dev, torch.float32, **case)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = _reference_attention(*leaves, pm, True, None, 0.15, 5)
    want = torch.autograd.grad(o, leaves, go)
    _assert_grads_close(got, want, torch.float32)


def test_bwd_kernel_rows_and_keys_nobody_sees_get_zeros(dev):
    got, _, (_, _, _, _, pm) = _bwd_case(dev, torch.float32, B=3, H=2,
                                         Tq=40, Tk=72, D=32, mask=True)
    dq, dk, dv = got
    assert torch.all(dq[0] == 0)                    # the empty batch row
    dead = (pm == 0)[:, None, :, None].expand_as(dk)
    assert torch.all(dk[dead] == 0) and torch.all(dv[dead] == 0)


def _pages(dev, dtype, P, bs, Hkv, D, g):
    """K/V pools with finite garbage (1e4) in the scratch page 0."""
    kp = torch.randn(P, bs, Hkv, D, generator=g)
    vp = torch.randn(P, bs, Hkv, D, generator=g)
    kp[0], vp[0] = 1e4, -1e4
    return kp.to(dev, dtype), vp.to(dev, dtype)


def _assert_paged_close(out, ref, dtype):
    atol, rtol = _tol(dtype)
    assert out.dtype == dtype and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


def _decode_run(dev, dtype, B, H, Hkv, D, bs, nb, lengths, seed=3):
    """paged_decode against its plain version, one counted launch; each
    sequence on its own pages, table entries past ``ceil(len / bs)``
    pointing at the scratch page, which holds garbage."""
    P = B * nb + 1
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, D, generator=g).to(dev, dtype)
    kp, vp = _pages(dev, dtype, P, bs, Hkv, D, g)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    tables = (torch.randperm(P - 1, generator=g)[:B * nb] + 1).int()
    tables = tables.view(B, nb)
    used = (lengths[:, None] + bs - 1) // bs
    tables[torch.arange(nb)[None, :] >= used] = 0     # -> scratch
    args = (q, kp, vp, lengths.to(dev), tables.to(dev))
    before = _kernels.paged_decode.launches
    out = paged_decode_attention(*args)
    ref = paged_decode_attention(*args, backend="plain")
    torch.cuda.synchronize()
    assert _kernels.paged_decode.launches == before + 1
    _assert_paged_close(out, ref, dtype)
    assert torch.all(out[(lengths == 0).to(dev)] == 0)   # dead lanes
    return out, args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(H=8, Hkv=2, D=64, bs=16, nb=8),
    dict(H=4, Hkv=4, D=128, bs=16, nb=5),
    dict(H=12, Hkv=4, D=32, bs=8, nb=20),
    dict(H=8, Hkv=8, D=64, bs=32, nb=12),
    dict(H=6, Hkv=2, D=64, bs=12, nb=15),
    dict(H=16, Hkv=1, D=128, bs=16, nb=9),
], ids=["gqa_d64", "mha_d128", "gqa3_d32", "bs32", "bs12_off_chunk",
        "gqa16_d128"])
def test_paged_decode_matches_plain(dev, dtype, case):
    """Lengths 0 (a dead lane), below one block, not a block multiple,
    the full table; table entries past each sequence point at the
    scratch page, which holds garbage."""
    bs, nb = case["bs"], case["nb"]
    _decode_run(dev, dtype, 6, case["H"], case["Hkv"], case["D"], bs, nb,
                [0, 1, bs - 3, 2 * bs + 5, nb * bs, nb * bs - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(12, 12), (12, 4)], ids=["mha", "gqa"])
def test_paged_decode_long_sequences_take_many_splits(dev, dtype, heads):
    """4,096-token tables: many splits per sequence, merged in order."""
    H, Hkv = heads
    bs, nb = 16, 256
    splits, _ = _kernels.decode_splits(4, Hkv, nb, bs,
                                       _kernels.sm_count(dev))
    assert splits >= 8
    _decode_run(dev, dtype, 4, H, Hkv, 64, bs, nb, [4096, 4095, 1000, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_splits_past_a_sequence_read_nothing(dev, dtype):
    """Wide tables, short sequences: most splits start past the length
    and exit.  The entries past each sequence hold out-of-range ids,
    which the kernel would clamp onto a real page had it read them."""
    B, H, D, bs, nb = 5, 4, 64, 16, 128
    assert _kernels.decode_splits(B, H, nb, bs,
                                  _kernels.sm_count(dev))[0] > 1
    lengths = [3, 17, 200, 0, 2048]
    g = torch.Generator().manual_seed(9)
    P = B * nb + 1
    q = torch.randn(B, H, D, generator=g).to(dev, dtype)
    kp, vp = _pages(dev, dtype, P, bs, H, D, g)
    tables = (torch.randperm(P - 1, generator=g)[:B * nb] + 1).int()
    tables = tables.view(B, nb)
    lens = torch.tensor(lengths, dtype=torch.int32)
    past = torch.arange(nb)[None, :] >= (lens[:, None] + bs - 1) // bs
    tables[past] = 0
    ref = paged_decode_attention(q, kp, vp, lens.to(dev), tables.to(dev),
                                 backend="plain")
    tables[past] = 10 ** 6
    out = paged_decode_attention(q, kp, vp, lens.to(dev), tables.to(dev))
    torch.cuda.synchronize()
    _assert_paged_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_at_the_serving_shape(dev, dtype):
    """GPT-2-small serving: B 32, 12 heads of 64, 64-entry tables of 16,
    lengths 0..1024 (a dead lane, the full table, one off a block)."""
    g = torch.Generator().manual_seed(11)
    lengths = torch.randint(0, 1025, (32,), generator=g)
    lengths[:3] = torch.tensor([0, 1024, 1000])
    _decode_run(dev, dtype, 32, 12, 12, 64, 16, 64, lengths.tolist())


def _chunk_run(dev, dtype, H, Hkv, D, Tc, start, n, bs=16, seed=4):
    """paged_chunk against its plain version on its ``n`` true rows, one
    counted launch: a chunk at ``start`` whose own K/V sit in the pages,
    the table longer than the sequence with its tail at the scratch page,
    which holds garbage."""
    used = (start + n + bs - 1) // bs
    nb, P = used + 3, 3 * (used + 3)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(Tc, H, D, generator=g).to(dev, dtype)
    kp, vp = _pages(dev, dtype, P, bs, Hkv, D, g)
    table = torch.zeros(nb, dtype=torch.int32)
    table[:used] = torch.randperm(P - 1, generator=g)[:used].int() + 1
    table = table.to(dev)
    before = _kernels.paged_chunk.launches
    out = paged_chunk_attention(q, kp, vp, table, start)
    ref = paged_chunk_attention(q, kp, vp, table, start, backend="plain")
    torch.cuda.synchronize()
    assert _kernels.paged_chunk.launches == before + 1
    assert out.shape == (Tc, H, D)
    _assert_paged_close(out[:n], ref[:n], dtype)
    return out, (q, kp, vp, table, start)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(H=4, Hkv=4, D=64, Tc=64, start=0, n=64),
    dict(H=8, Hkv=2, D=64, Tc=96, start=133, n=70),   # padded tail
    dict(H=4, Hkv=1, D=128, Tc=40, start=17, n=40),
    dict(H=4, Hkv=4, D=32, Tc=100, start=300, n=90, bs=32),
    dict(H=4, Hkv=2, D=64, Tc=130, start=77, n=130, bs=24),
    dict(H=2, Hkv=2, D=128, Tc=64, start=1000, n=5, bs=8),
], ids=["start0_d64", "gqa_start_padded_tail", "gqa4_d128", "bs32_d32",
        "bs24_off_tile", "d128_bs8_long"])
def test_paged_chunk_matches_plain(dev, dtype, case):
    """A chunk at ``start`` whose own K/V sit in the pages, padded past
    its ``n`` true rows; the table is longer than the sequence and its
    tail points at the scratch page, which holds garbage."""
    _chunk_run(dev, dtype, **case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start", [0, 256, 512])
def test_paged_chunk_at_the_serving_shape(dev, dtype, start):
    """GPT-2-small prefill: a 256-token chunk of 12 heads of 64, pages of
    16; at start 512 each row block's keys are split over blocks."""
    _chunk_run(dev, dtype, 12, 12, 64, 256, start, 256)


def test_paged_kernels_repeat_bit_identical(dev):
    """No float atomics: the split merges run in a fixed order."""
    for dtype in (torch.float32, torch.bfloat16):
        out, args = _decode_run(dev, dtype, 8, 12, 12, 64, 16, 256,
                                [4096, 3000, 17, 0, 1, 2048, 4000, 600])
        assert torch.equal(out, paged_decode_attention(*args))
        out, args = _chunk_run(dev, dtype, 12, 12, 64, 256, 512, 256)
        assert torch.equal(out, paged_chunk_attention(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_pools_off_16_bytes_are_copied_and_right(dev, dtype):
    """Page pools whose base is one element off a 16-byte boundary reach
    the kernels as packed copies, counted in the wrappers' ``copies``."""
    B, H, D, bs, nb = 3, 4, 64, 16, 4
    P = B * nb + 1
    n = P * bs * H * D
    g = torch.Generator().manual_seed(12)
    flat = torch.randn(2 * n + 2, generator=g).to(dev, dtype)
    kp = flat[1:1 + n].view(P, bs, H, D)
    vp = flat[n + 2:].view(P, bs, H, D)
    q = torch.randn(B, H, D, generator=g).to(dev, dtype)
    lengths = torch.tensor([5, 64, 0], dtype=torch.int32, device=dev)
    tables = torch.arange(1, 1 + B * nb, dtype=torch.int32,
                          device=dev).view(B, nb)
    before = _kernels.paged_decode.copies
    out = paged_decode_attention(q, kp, vp, lengths, tables)
    ref = paged_decode_attention(q, kp, vp, lengths, tables,
                                 backend="plain")
    torch.cuda.synchronize()
    assert _kernels.paged_decode.copies == before + 2
    _assert_paged_close(out, ref, dtype)
    qc = torch.randn(20, H, D, generator=g).to(dev, dtype)
    before = _kernels.paged_chunk.copies
    out = paged_chunk_attention(qc, kp, vp, tables[0], 30)
    ref = paged_chunk_attention(qc, kp, vp, tables[0], 30, backend="plain")
    torch.cuda.synchronize()
    assert _kernels.paged_chunk.copies == before + 2
    _assert_paged_close(out[:20], ref[:20], dtype)


def test_paged_chunk_reaches_the_tensor_cores(dev):
    """cuobjdump of the built paged_chunk.cu: HGMMA in its bf16
    instances, HMMA in its f32 ones."""
    lib = _kernels.build(["paged_chunk.cu"])["paged_chunk.cu"]
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {"bf16": 0, "f32": 0}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1]
            fn = ("bf16" if "paged_chunk_bf16" in name else
                  "f32" if "paged_chunk_f32" in name else None)
        elif fn == "bf16" and "HGMMA" in line:
            counts["bf16"] += 1
        elif fn == "f32" and "HMMA" in line:
            counts["f32"] += 1
    assert counts["bf16"] > 0 and counts["f32"] > 0, counts


def test_paged_kernels_refuse_what_they_do_not_take(dev):
    q = torch.randn(2, 4, 48, device=dev)
    pages = torch.randn(3, 4, 4, 48, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        paged_decode_attention(q, pages, pages, lens, tables)
    q = torch.randn(2, 4, 64, device=dev)
    pages = torch.randn(3, 4, 4, 64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, pages, pages, lens, tables.long())
    with pytest.raises(ValueError, match="int32"):
        paged_chunk_attention(q, pages, pages, tables[0].long(), 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(B=2, H=12, Tq=256, Tk=256, D=64, causal=False),
    dict(B=2, H=3, Tq=200, Tk=200, D=32, causal=True),
    dict(B=1, H=4, Tq=100, Tk=300, D=128, causal=True),
    dict(B=2, H=2, Tq=77, Tk=50, D=64, causal=True),
    dict(B=2, H=4, Tq=1000, Tk=700, D=64, causal=True),
], ids=["full", "diag_ragged_d32", "causal_tq_lt_tk_d128", "empty_rows",
        "causal_tq1000_gt_tk700"])
def test_flash_fwd_lse_matches_plain(dev, dtype, case):
    """Strided head views in; rows that see no key give o = 0 and lse
    exactly -1e30 (finite, so the ring's merge never meets inf - inf)."""
    B, H, Tq, Tk, D = (case[k] for k in ("B", "H", "Tq", "Tk", "D"))
    g = torch.Generator().manual_seed(5)
    mk = lambda T: torch.randn(B, T, H, D, generator=g).to(dev, dtype) \
        .transpose(1, 2)
    q, k, v = mk(Tq), mk(Tk), mk(Tk)
    before = _kernels.flash_fwd_lse.launches
    o, lse = flash_forward_with_lse(q, k, v, causal=case["causal"])
    ro, rlse = flash_forward_with_lse(q, k, v, causal=case["causal"],
                                      backend="plain")
    torch.cuda.synchronize()
    assert _kernels.flash_fwd_lse.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (B, H, Tq) and lse.is_contiguous()
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=rtol)
    assert torch.all((lse - rlse).abs() <= 1e-5 * rlse.abs().clamp_min(1.0))
    empty = rlse == -1e30
    assert empty.any() == (Tq > Tk)
    assert torch.all(lse[empty] == -1e30) and torch.all(o[empty] == 0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_on_four_shards_of_one_card(dev, causal):
    """sp(sp+1)/2 kernel launches causal, sp^2 not; output and gradients
    against the ring with plain blocks and against dense attention."""
    mesh = Mesh([str(dev) + ":0"] * 4, ("sequence",))
    B, H, T, D = 2, 3, 512, 64
    g = torch.Generator().manual_seed(6)
    q, k, v, go = (torch.randn(B, H, T, D, generator=g).to(dev)
                   for _ in range(4))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, go)

    before = _kernels.flash_fwd_lse.launches
    o, grads = run(lambda *t: ring_attention(*t, mesh, causal=causal))
    assert _kernels.flash_fwd_lse.launches - before == (10 if causal else 16)
    for want_o, want_g in (
            run(lambda *t: ring_attention(*t, mesh, causal=causal,
                                          impl="plain")),
            run(lambda *t: _reference_attention(*t, causal=causal))):
        torch.testing.assert_close(o, want_o, atol=2e-5, rtol=0)
        for name, a, b in zip("qkv", grads, want_g):
            atol = 1e-4 * max(1.0, b.abs().max().item())
            torch.testing.assert_close(a, b, atol=atol, rtol=0,
                                       msg=f"d{name}")


# --- the forward's lse and the ring block's backward ----------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_lse_equals_flash_fwd_lse_and_the_plain_lse(dev, dtype):
    """Where both entry points apply (no mask, no dropout) the forward's
    lse equals ``flash_fwd_lse``'s; under a mask with an empty row and
    dropout it is the plain log-sum-exp of the visible scores before
    dropout, -1e30 on the empty row."""
    B, H, Tq, Tk, D = 3, 2, 77, 130, 64
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(B, H, T, D, generator=g).to(dev, dtype)
               for T in (Tq, Tk, Tk))
    _, lse = _kernels.flash_fwd(q, k, v, causal=True, sm_scale=0.125,
                                with_lse=True)
    _, want = _kernels.flash_fwd_lse(q, k, v, causal=True, sm_scale=0.125)
    assert lse.shape == (B, H, Tq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)
    lens = torch.tensor([0, 60, Tk])
    mask = (torch.arange(Tk)[None] < lens[:, None]).int().to(dev)
    _, lse = _kernels.flash_fwd(q, k, v, mask, sm_scale=0.125,
                                dropout_thresh=1 << 22, keep_scale=4 / 3,
                                seed=3, with_lse=True)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * 0.125
    s = torch.where(_valid((Tq, Tk), dev, False, mask), s, -torch.inf)
    want = torch.logsumexp(s, -1)
    empty = torch.isinf(want)
    assert torch.all(lse[empty] == -1e30) and empty[0].all()
    torch.testing.assert_close(lse[~empty], want[~empty], atol=1e-5,
                               rtol=1e-5)


def _ring_block(dev, dtype, B, H, T, D, causal, seed, init=0.0):
    """(kernel accumulators, plain accumulators, inputs) of one ring block
    from ``init`` * random accumulators, with the block's own lse."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, go = (torch.randn(B, H, T, D, generator=g).to(dev, dtype)
                   for _ in range(4))
    o, lse = _reference_attention_with_lse(q, k, v, causal, D ** -0.5)
    delta = _row_delta(o, go)
    acc0 = [init * torch.randn(B, H, T, D, generator=g).to(dev)
            for _ in range(3)]
    out = {}
    for impl in ("cuda", "plain"):
        acc = [t.clone() for t in acc0]
        _block_grads(q, go, lse, delta, k, v, 0 if causal else None,
                     D ** -0.5, *acc, impl=impl)
        out[impl] = acc
    torch.cuda.synchronize()
    return out["cuda"], out["plain"], (q, k, v, go, lse, delta, acc0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(B=2, H=3, T=512, D=64, causal=False),
    dict(B=2, H=3, T=512, D=64, causal=True),
    dict(B=1, H=2, T=300, D=32, causal=True),
    dict(B=1, H=2, T=200, D=128, causal=False),
], ids=["full", "diagonal", "ragged_d32", "ragged_d128"])
def test_flash_bwd_lse_matches_plain_block(dev, dtype, case):
    before = _kernels.flash_bwd_lse.launches
    got, want, _ = _ring_block(dev, dtype, **case, seed=10)
    assert _kernels.flash_bwd_lse.launches == before + 1
    _assert_block_close(got, want, dtype)


def _assert_block_close(got, want, dtype):
    """f32 accumulators of a ring block, held to the backward's
    tolerances for the inputs' dtype."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        atol, rtol = ((1e-4 * max(1.0, b.abs().max().item()), 0.0)
                      if dtype == torch.float32 else (2e-2, 2.0 ** -6))
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_lse_adds_into_its_accumulators(dev, dtype):
    """From nonzero accumulators the kernel adds what it writes from zero
    ones: dk and dv in one f32 add each; dq too in bf16, while the f32
    kernel adds each key tile's share of dq in turn, so there the sum is
    the same up to f32 rounding."""
    kw = dict(B=2, H=3, T=256, D=64, causal=True, seed=11)
    from_zero, _, _ = _ring_block(dev, dtype, **kw)
    got, want, (*_, acc0) = _ring_block(dev, dtype, **kw, init=1.0)
    for name, a, z, a0 in zip(("dq", "dk", "dv"), got, from_zero, acc0):
        if name == "dq" and dtype == torch.float32:
            torch.testing.assert_close(a, a0 + z, atol=1e-5, rtol=0)
        else:
            assert torch.equal(a, a0 + z), name
    _assert_block_close(got, want, dtype)


def test_flash_bwd_lse_repeats_bit_identical(dev):
    kw = dict(B=2, H=3, T=384, D=64, causal=False, seed=12)
    first, _, _ = _ring_block(dev, torch.float32, **kw)
    again, _, _ = _ring_block(dev, torch.float32, **kw)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
