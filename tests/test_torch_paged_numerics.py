"""The paged kernels' algorithms in plain PyTorch, on the CPU.

``ops/csrc/paged_decode.cu`` splits each sequence's keys over blocks and
``ops/csrc/paged_chunk.cu`` splits each 64-row block's key tiles, both
merging the splits in split order; neither kernel runs here.  These tests
emulate what the kernels compute, step for step (the split ranges from
``ops/_kernels``' split rules, 16-key chunks dealt to four warps merged in
warp order, 64-key tiles under the start-shifted causal mask capped at
``nb * bs``, exp2 online softmax, normalised partials and their
log-sum-exp merged in split order), and hold the result to the port's plain
versions and to the JAX package's ``_gather_reference`` /
``paged_chunk_attention`` on the same numpy inputs, to 1e-6 in f32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import paged_attention as jpa
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import paged_attention as tpa

ATOL = 1e-6
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
WARPS, CHUNK = 4, 16                    # the decode kernel's warps, keys
BLOCK_M, BLOCK_N = _kernels.CHUNK_BLOCK_M, _kernels.CHUNK_BLOCK_N


def _softmax_step(m, l, acc, s2, v):
    """One online-softmax step in exp2 units: s2 (rows, keys) the scaled
    scores (-inf where masked), v (keys, D)."""
    m_new = torch.maximum(m, s2.max(dim=-1).values)
    base = torch.where(m_new == -math.inf, 0.0, m_new)
    alpha = torch.exp2(m - base)
    p = torch.exp2(s2 - base[:, None])
    return m_new, alpha * l + p.sum(-1), acc * alpha[:, None] + p @ v


def _merge(parts):
    """Partials (o normalised by its own sum, lse) merged in split order."""
    if not parts:
        return None
    lse = torch.stack([x for _, x in parts])             # (n, rows)
    w = torch.exp(lse - lse.max(dim=0).values)
    num = sum(w[i][:, None] * o for i, (o, _) in enumerate(parts))
    return num / w.sum(0)[:, None]


def emulate_decode(q, kp, vp, lengths, tables, sm_scale, splits, pages,
                   read=None):
    """``paged_decode.cu``'s algorithm; ``read`` collects the table
    entries each sequence's splits look up."""
    B, H, D = q.shape
    P, bs, Hkv, _ = kp.shape
    nb = tables.shape[1]
    G = H // Hkv
    split_keys = pages * bs
    out = torch.zeros(B, H, D)
    for b in range(B):
        n = min(max(int(lengths[b]), 0), nb * bs)
        for kvh in range(Hkv):
            heads = slice(kvh * G, (kvh + 1) * G)
            qs = q[b, heads]                              # (G, D)
            parts = []
            for s in range(splits):
                lo, hi = s * split_keys, min(n, (s + 1) * split_keys)
                if lo >= n:
                    continue                              # exits at once
                keys = torch.arange(lo, hi)
                blk = keys // bs
                if read is not None and kvh == 0:
                    read.setdefault(b, []).extend(blk.unique().tolist())
                page = tables[b, blk].long().clamp(0, P - 1)
                k = kp[page, keys % bs, kvh]              # (n, D)
                v = vp[page, keys % bs, kvh]
                chunks = -(-(hi - lo) // CHUNK)
                warps = []
                for w in range(WARPS):
                    m = torch.full((G,), -math.inf)
                    l, acc = torch.zeros(G), torch.zeros(G, D)
                    for c in range(w, chunks, WARPS):
                        kc = k[c * CHUNK:(c + 1) * CHUNK]
                        vc = v[c * CHUNK:(c + 1) * CHUNK]
                        s2 = (qs @ kc.T) * (sm_scale * LOG2E)
                        m, l, acc = _softmax_step(m, l, acc, s2, vc)
                    warps.append((m, l, acc))
                mx = torch.stack([m for m, _, _ in warps]).max(0).values
                den = sum(l * torch.exp2(m - mx) for m, l, _ in warps)
                num = sum(a * torch.exp2(m - mx)[:, None]
                          for m, _, a in warps)
                parts.append((num / den[:, None],
                              (mx + torch.log2(den)) * LN2))
            if splits == 1:
                o = parts[0][0] if parts else None
            else:
                o = _merge(parts)
            if o is not None:
                out[b, heads] = o
    return out


def emulate_chunk(q, kp, vp, table, start, sm_scale, splits):
    """``paged_chunk.cu``'s algorithm, rows of every block."""
    Tc, H, D = q.shape
    P, bs, Hkv, _ = kp.shape
    nb = table.shape[0]
    cap = nb * bs
    scale2 = sm_scale * LOG2E
    out = torch.zeros(Tc, H, D)
    for h in range(H):
        kvh = h // (H // Hkv)
        for q0 in range(0, Tc, BLOCK_M):
            rows = torch.arange(q0, min(q0 + BLOCK_M, Tc))
            k_end = min(cap, max(0, start + rows[-1].item() + 1))
            n_tiles = -(-k_end // BLOCK_N)
            per = max(1, -(-n_tiles // splits))
            parts = []
            for s in range(splits):
                t_lo = min(n_tiles, s * per)
                t_hi = min(n_tiles, t_lo + per)
                if splits > 1 and t_lo >= t_hi:
                    continue                              # the merge skips
                m = torch.full((len(rows),), -math.inf)
                l, acc = torch.zeros(len(rows)), torch.zeros(len(rows), D)
                for t in range(t_lo, t_hi):
                    keys = torch.arange(t * BLOCK_N, (t + 1) * BLOCK_N)
                    loaded = keys < k_end                 # else zero-filled
                    k = torch.zeros(BLOCK_N, D)
                    v = torch.zeros(BLOCK_N, D)
                    kk = keys[loaded]
                    page = table[kk // bs].long().clamp(0, P - 1)
                    k[loaded] = kp[page, kk % bs, kvh]
                    v[loaded] = vp[page, kk % bs, kvh]
                    seen = (keys[None] < cap) & (keys[None]
                                                 <= start + rows[:, None])
                    s2 = torch.where(seen, (q[rows, h] @ k.T) * scale2,
                                     -math.inf)
                    m, l, acc = _softmax_step(m, l, acc, s2, v)
                o = torch.where(l[:, None] > 0,
                                acc / l.clamp_min(1e-37)[:, None], 0.0)
                lse = torch.where(l > 0, m * LN2 + torch.log(l), -1e30)
                parts.append((o, lse))
            o = parts[0][0] if splits == 1 else _merge(parts)
            if o is not None:
                out[rows, h] = o
    return out


def _decode_inputs(rng, B, H, Hkv, D, bs, nb, lengths):
    P = B * nb + 1
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4                # the scratch page: garbage
    tables = (rng.permutation(P - 1)[:B * nb] + 1).reshape(B, nb)
    lengths = np.asarray(lengths, np.int32)
    used = -(-lengths // bs)
    tables[np.arange(nb)[None, :] >= used[:, None]] = 0
    return q, kp, vp, lengths, tables.astype(np.int32)


def _jax_decode(q, kp, vp, lengths, tables, scale):
    return np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(tables), sm_scale=scale,
        backend="jnp"))


# ---------------------------------------------------------------------------
# the decode split rule


@pytest.mark.parametrize("shape", [
    (32, 12, 64, 16), (1, 1, 64, 16), (4, 2, 5, 16), (3, 1, 33, 7),
    (8, 4, 256, 32), (2, 2, 1, 1), (64, 12, 64, 16), (32, 12, 128, 8),
])
@pytest.mark.parametrize("n_sms", [1, 132])
def test_decode_splits_cover_every_table_entry_once(shape, n_sms):
    B, Hkv, nb, bs = shape
    splits, pages = _kernels.decode_splits(B, Hkv, nb, bs, n_sms)
    assert splits >= 1 and pages >= 1
    covered = [e for s in range(splits)
               for e in range(s * pages, min(nb, (s + 1) * pages))]
    assert covered == list(range(nb))               # once each, in order
    assert (splits - 1) * pages < nb                # no split wholly empty
    if splits > 1:                                  # none too short
        assert pages * bs >= _kernels.DECODE_MIN_SPLIT_KEYS


def test_decode_splits_suit_the_card():
    """At GPT-2-small serving (B 32, 12 KV heads, 64-entry tables of 16)
    the 132 SMs of an H100 get more blocks than the 384 pairs; one SM
    gets one block a pair."""
    splits, pages = _kernels.decode_splits(32, 12, 64, 16, 132)
    assert 32 * 12 * splits > 384 and splits * pages >= 64
    assert _kernels.decode_splits(32, 12, 64, 16, 1) == (1, 64)
    assert _kernels.decode_splits(1, 1, 0, 16, 132) == (1, 1)


@pytest.mark.parametrize("splits,pages", [(1, 6), (2, 3), (3, 2), (6, 1)])
def test_splits_past_a_sequence_read_nothing(splits, pages):
    """Each sequence's splits together look up exactly its first
    ceil(len / bs) table entries, each once; a dead lane looks up none."""
    rng = np.random.default_rng(5)
    bs, nb = 8, 6
    lengths = [0, 1, 7, 8, 9, 23, 40, 48]
    q, kp, vp, lens, tables = _decode_inputs(rng, len(lengths), 2, 2, 32,
                                             bs, nb, lengths)
    read = {}
    emulate_decode(torch.from_numpy(q), torch.from_numpy(kp),
                   torch.from_numpy(vp), torch.from_numpy(lens),
                   torch.from_numpy(tables), 0.2, splits, pages, read)
    for b, n in enumerate(lengths):
        assert sorted(read.get(b, [])) == list(range(-(-n // bs)))


# ---------------------------------------------------------------------------
# split-and-merge decode


@pytest.mark.parametrize("splits,pages", [(1, 8), (2, 4), (3, 3), (8, 1)],
                         ids=["one", "two", "uneven", "one_page_each"])
@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_split_decode_matches_the_references(splits, pages, heads):
    """Several split counts, splits that hold no key of a short sequence,
    a dead lane and lengths that are no multiple of bs."""
    H, Hkv = heads
    bs, nb, D = 16, 8, 32
    lengths = [0, 1, 15, 16, 17, 45, 100, 128]
    rng = np.random.default_rng(6)
    q, kp, vp, lens, tables = _decode_inputs(rng, len(lengths), H, Hkv, D,
                                             bs, nb, lengths)
    scale = 1.0 / math.sqrt(D)
    t = [torch.from_numpy(x) for x in (q, kp, vp, lens, tables)]
    got = emulate_decode(*t, scale, splits, pages)
    plain = tpa._gather_reference(*t, scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(),
                               _jax_decode(q, kp, vp, lens, tables, scale),
                               atol=ATOL, rtol=0)
    assert torch.all(got[0] == 0)                   # the dead lane


def test_split_decode_with_the_rule_at_serving_width():
    """The split the rule picks for 132 SMs at the serving shape's table
    width (64 entries of 16), on a few sequences of ragged lengths."""
    bs, nb, D, H = 16, 64, 64, 2
    splits, pages = _kernels.decode_splits(32, 12, nb, bs, 132)
    lengths = [1024, 1000, 257, 3]
    rng = np.random.default_rng(7)
    q, kp, vp, lens, tables = _decode_inputs(rng, 4, H, H, D, bs, nb,
                                             lengths)
    t = [torch.from_numpy(x) for x in (q, kp, vp, lens, tables)]
    got = emulate_decode(*t, 0.125, splits, pages)
    np.testing.assert_allclose(
        got.numpy(), _jax_decode(q, kp, vp, lens, tables, 0.125),
        atol=ATOL, rtol=0)


def test_out_of_range_page_ids_are_clamped_as_jax_clamps_them():
    bs, nb, D = 4, 3, 32
    rng = np.random.default_rng(8)
    q, kp, vp, lens, tables = _decode_inputs(rng, 2, 2, 2, D, bs, nb,
                                             [12, 9])
    tables[0, 1], tables[1, 2] = 10 ** 6, 2 ** 30   # past P: the last page
    t = [torch.from_numpy(x) for x in (q, kp, vp, lens, tables)]
    got = emulate_decode(*t, 0.3, 2, 2)
    np.testing.assert_allclose(got.numpy(),
                               _jax_decode(q, kp, vp, lens, tables, 0.3),
                               atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the chunk's split rule and its start-shifted, capped causal mask


@pytest.mark.parametrize("n_sms", [1, 132])
def test_chunk_splits(n_sms):
    # serving: 12 heads x 4 row blocks = 48 blocks; twice 132 SMs wants 6
    # splits, which the first row block's 9 key tiles allow
    s = _kernels.chunk_splits(12, 256, 512, 64, 16, n_sms)
    assert s == (6 if n_sms == 132 else 1)
    # at start 256 the first row block's 5 key tiles allow 5
    assert _kernels.chunk_splits(12, 256, 256, 64, 16, n_sms) == (
        5 if n_sms == 132 else 1)
    # at start 0 the first row block sees one tile: nothing to split
    assert _kernels.chunk_splits(12, 256, 0, 64, 16, n_sms) == 1
    # enough row blocks already
    assert _kernels.chunk_splits(80, 256, 512, 64, 16, n_sms) == 1


def _chunk_inputs(rng, Tc, H, Hkv, D, bs, nb, used):
    P = 3 * nb + 1
    q = rng.standard_normal((Tc, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, bs, Hkv, D)).astype(np.float32)
    kp[0], vp[0] = 1e4, -1e4
    table = np.zeros(nb, np.int32)
    table[:used] = rng.permutation(P - 1)[:used] + 1
    return q, kp, vp, table


@pytest.mark.parametrize("case", [
    dict(Tc=130, start=0, n=130, splits=1),
    dict(Tc=64, start=150, n=64, splits=2),
    dict(Tc=128, start=200, n=100, splits=3),      # padded tail
    dict(Tc=64, start=230, n=26, splits=4),        # tail runs past nb * bs
    dict(Tc=40, start=17, n=40, splits=5),         # more splits than tiles
], ids=["start0", "two_splits", "padded_tail", "tail_past_table",
        "empty_splits"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_chunk_matches_the_references(case, heads):
    """True rows against JAX; every row against the port's plain version
    (whose mask is the same: key <= start + row, keys < nb * bs)."""
    H, Hkv = heads
    bs, nb, D = 16, 16, 32                 # 256 keys in the table
    Tc, start, n, splits = (case[k] for k in ("Tc", "start", "n", "splits"))
    used = min(nb, -(-(start + n) // bs))
    rng = np.random.default_rng(9)
    q, kp, vp, table = _chunk_inputs(rng, Tc, H, Hkv, D, bs, nb, used)
    scale = 1.0 / math.sqrt(D)
    t = [torch.from_numpy(x) for x in (q, kp, vp, table)]
    got = emulate_chunk(*t, start, scale, splits)
    plain = tpa._reference_chunk(*t, start, scale)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                               rtol=0)
    want = jpa.paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(start, jnp.int32), sm_scale=scale)
    np.testing.assert_allclose(got[:n].numpy(), np.asarray(want)[:n],
                               atol=ATOL, rtol=0)


def test_chunk_diagonal_is_not_end_aligned():
    """A tail padded past nb * bs: an end-aligned diagonal (row i sees
    keys <= i + nb*bs - Tc) would hide keys from the true rows; the
    kernel's diagonal at ``start`` shows each row exactly its keys."""
    bs, nb, D, H = 16, 4, 32, 2
    Tc, start, n = 64, 40, 20              # rows 24.. run past 64 keys
    rng = np.random.default_rng(10)
    q, kp, vp, table = _chunk_inputs(rng, Tc, H, H, D, bs, nb, nb)
    t = [torch.from_numpy(x) for x in (q, kp, vp, table)]
    got = emulate_chunk(*t, start, 0.2, 1)
    want = tpa._reference_chunk(*t, start, 0.2)
    np.testing.assert_allclose(got[:n].numpy(), want[:n].numpy(),
                               atol=ATOL, rtol=0)
    aligned = tpa._reference_chunk(*t, nb * bs - Tc, 0.2)
    assert not np.allclose(aligned[:n].numpy(), want[:n].numpy(),
                           atol=1e-3)
