"""Ring attention: exact attention over a sequence-sharded axis.

Port of ``analytics_zoo_tpu/parallel/ring.py``.  Q stays resident per shard
while K/V blocks rotate around the ``axis_name`` axis of a ``Mesh``, with
online-softmax merging across ring steps (the blockwise / RingAttention
formulation of Liu et al.).

The JAX ring is single-controller: one program runs a ``shard_map`` and
rotates blocks with ``jax.lax.ppermute``.  The port keeps that model in one
process: each shard lives on the device at its mesh coordinate
(``parallel/mesh.py``), and a rotation moves each block to the next shard's
device with ``.to(device)``, which is free when the devices are the same
(several shards on one card, or on the host as the tests run it) and a
peer copy between cards.  Over several devices (``Mesh.block_streams``)
each shard runs its blocks and merges on its position's stream
(``Mesh.stream``), so the shards of one ring step overlap; a rotation
issues the receiver's copy on the receiver's stream after it waits for
the sender's, and the caller's stream waits for every shard's before the
outputs are joined.  Shards that share a device run on its current
stream, one after another.

Block math: the FORWARD runs the kernel ``flash_fwd_lse``
(``ops.attention.flash_forward_with_lse``) per visiting K/V block, merged
across steps by log-sum-exp; under ``causal`` a block wholly in the future
launches nothing.  The BACKWARD is a second ring pass: dq accumulates in
place, dK/dV ride the rotating blocks and arrive home after a full loop,
and each visible block adds its gradients from the saved global lse and
``delta = rowsum(g * o)``.  On a card a block runs the kernel
``flash_bwd_lse`` (``ops/csrc/flash_bwd.cu``), which adds into the f32
accumulators in place (the blocks of one shard run one after another on
one stream, so the sums are deterministic); on the host, or under
``impl="plain"``, it runs ``_block_grads``' plain f32 ``torch.matmul``
body, the JAX package's jnp math and the kernel's reference.  In bf16 the
kernel rounds P and dS to bf16 before their products, as ``flash_bwd``
does, where the plain blocks keep f32.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops.attention import (
    _NEG_INF, _reference_attention_with_lse, _row_delta,
    flash_forward_with_lse)
from analytics_zoo_tpu_torch.parallel.mesh import (Mesh, join, on_stream,
                                                   used_on)

IMPLS = ("auto", "cuda", "plain")
#: the JAX package's names: "pallas" is the kernel, "jnp" the plain blocks
JAX_IMPLS = {"pallas": "cuda", "jnp": "plain"}


def _block_attn(q, k_blk, v_blk, my_idx, owner, sm_scale, causal, impl):
    """(o, lse) of resident q against one K/V block.  The kernel path
    dispatches on visibility: a past block is full, the own block
    diagonal-causal, a future block sees nothing (zeros and -1e30, no
    launch).  The plain path masks with the per-block shift."""
    kernel = impl == "cuda" or (impl == "auto" and q.device.type == "cuda")
    if not kernel:
        shift = (my_idx - owner) * q.shape[2] if causal else None
        return _reference_attention_with_lse(q, k_blk, v_blk, causal,
                                             sm_scale, shift=shift)
    if causal and owner > my_idx:
        return (torch.zeros_like(q),
                torch.full(q.shape[:3], _NEG_INF, dtype=torch.float32,
                           device=q.device))
    return flash_forward_with_lse(q, k_blk, v_blk,
                                  causal=causal and owner == my_idx,
                                  sm_scale=sm_scale, backend="cuda")


def _merge(o_acc, lse_acc, o_i, lse_i):
    lse_new = torch.logaddexp(lse_acc, lse_i)
    w_acc = torch.exp(lse_acc - lse_new)
    w_i = torch.exp(lse_i - lse_new)
    o = o_acc * w_acc[..., None] + o_i.to(o_acc.dtype) * w_i[..., None]
    return o, lse_new


def _rotate(blocks: List[torch.Tensor], devices, streams
            ) -> List[torch.Tensor]:
    """One ppermute step: shard i receives shard i-1's block, on its own
    stream once that stream has waited for the sender's (``streams``:
    None on the host)."""
    out = []
    for i, dev in enumerate(devices):
        src = blocks[i - 1]
        with on_stream(streams[i]):
            if streams[i] is not None:
                streams[i].wait_stream(streams[i - 1])
                used_on([src], streams[i])
            out.append(src.to(dev))
    return out


def _ring_forward(q, k, v, sm_scale, causal, impl, streams):
    """q, k, v: one ring's shards, ``(B, H, T_loc, D)`` each on its device
    (and its position's stream: ``streams``, each already waiting for the
    inputs); returns the shards' o (q's dtype) and lse (f32)."""
    sp = len(q)
    devices = [t.device for t in q]
    k_blk, v_blk, owner = list(k), list(v), list(range(sp))
    o_acc, lse_acc = [], []
    for t, s in zip(q, streams):
        with on_stream(s):
            o_acc.append(torch.zeros(t.shape, dtype=torch.float32,
                                     device=t.device))
            lse_acc.append(torch.full(t.shape[:3], _NEG_INF,
                                      dtype=torch.float32, device=t.device))
    for step in range(sp):
        for i in range(sp):
            with on_stream(streams[i]):
                o_i, lse_i = _block_attn(q[i], k_blk[i], v_blk[i], i,
                                         owner[i], sm_scale, causal, impl)
                o_acc[i], lse_acc[i] = _merge(o_acc[i], lse_acc[i], o_i,
                                              lse_i)
        if step + 1 < sp:            # the last rotation would only go home
            k_blk = _rotate(k_blk, devices, streams)
            v_blk = _rotate(v_blk, devices, streams)
            owner = owner[-1:] + owner[:-1]
    out = []
    for o, t, s in zip(o_acc, q, streams):
        with on_stream(s):
            out.append(o.to(t.dtype))
    return out, lse_acc


def _block_grads(q, g, lse, delta, k_blk, v_blk, shift, sm_scale, dq,
                 dk_blk, dv_blk, impl="auto"):
    """Adds one visible block's contribution to the f32 accumulators dq,
    dk_blk and dv_blk in place.  ``shift``: None for a block every row
    sees wholly, else row r sees key c iff ``r + shift >= c``.  The
    kernel path (``impl`` ``"cuda"``, or ``"auto"`` on a card) launches
    ``flash_bwd_lse``, which takes a full block or the end-aligned
    diagonal one; otherwise the plain f32 matmuls below."""
    if impl == "cuda" or (impl == "auto" and q.device.type == "cuda"):
        if q.device.type != "cuda":
            raise ValueError(f"the flash_bwd_lse kernel needs CUDA tensors; "
                             f"got {q.device} (impl={impl!r})")
        Tq, Tk = q.shape[2], k_blk.shape[2]
        if shift is not None and shift < Tk - 1 and shift != Tk - Tq:
            raise ValueError(f"flash_bwd_lse takes a full or an end-aligned "
                             f"causal block, not shift {shift}")
        _kernels.flash_bwd_lse(q, k_blk, v_blk, g, lse, delta, dq, dk_blk,
                               dv_blk, causal=shift is not None
                               and shift < Tk - 1, sm_scale=sm_scale)
        return
    qf, gf = q.float(), g.float()
    kf, vf = k_blk.float(), v_blk.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if shift is not None:
        T_loc = s.shape[-1]
        r = torch.arange(T_loc, device=s.device)[:, None]
        c = torch.arange(T_loc, device=s.device)[None, :]
        s = torch.where(r + shift >= c, s, _NEG_INF)
    p = torch.where(s <= _NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
    del s
    dv_blk.add_(torch.matmul(p.transpose(-1, -2), gf))
    ds = p * (torch.matmul(gf, vf.transpose(-1, -2)) - delta[..., None]) \
        * sm_scale
    del p
    dq.add_(torch.matmul(ds, kf))
    dk_blk.add_(torch.matmul(ds.transpose(-1, -2), qf))


def _ring_bwd_pass(q, k, v, o, lse, g, sm_scale, causal, impl, streams):
    """Second ring pass over one ring's shards, each on its stream: dq
    accumulates in place; dk/dv ride the rotating blocks and are home
    after sp steps."""
    sp = len(q)
    T_loc = q[0].shape[2]
    devices = [t.device for t in q]
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                  device=t.device)
    delta, dq, dk_blk, dv_blk = [], [], [], []
    for i, s in enumerate(streams):
        with on_stream(s):
            delta.append(_row_delta(o[i], g[i]))
            dq.append(zeros(q[i]))
            dk_blk.append(zeros(k[i]))
            dv_blk.append(zeros(v[i]))
    k_blk, v_blk, owner = list(k), list(v), list(range(sp))
    for _ in range(sp):
        for i in range(sp):
            if causal and owner[i] > i:
                continue     # wholly in the future: contributes nothing
            shift = (i - owner[i]) * T_loc if causal else None
            with on_stream(streams[i]):
                _block_grads(q[i], g[i], lse[i], delta[i], k_blk[i],
                             v_blk[i], shift, sm_scale, dq[i], dk_blk[i],
                             dv_blk[i], impl)
        k_blk = _rotate(k_blk, devices, streams)
        v_blk = _rotate(v_blk, devices, streams)
        dk_blk = _rotate(dk_blk, devices, streams)
        dv_blk = _rotate(dv_blk, devices, streams)
        owner = owner[-1:] + owner[:-1]
    out = ([], [], [])
    for i, s in enumerate(streams):
        with on_stream(s):
            for acc, ref, dst in ((dq, q, out[0]), (dk_blk, k, out[1]),
                                  (dv_blk, v, out[2])):
                dst.append(acc[i].to(ref[i].dtype))
    return out


class _Layout:
    """How global ``(B, H, T, D)`` tensors split over the mesh: B over
    ``batch_axis`` (when it divides), T over ``axis_name``; each shard on
    the device at its coordinate (index 0 on every other axis, over which
    the JAX ``shard_map`` replicates)."""

    def __init__(self, mesh: Mesh, axis_name: str, batch_axis, B: int,
                 T: int):
        if axis_name not in mesh.shape:
            raise ValueError(f"no mesh axis {axis_name!r}; axes are "
                             f"{mesh.axis_names}")
        self.sp = mesh.shape[axis_name]
        if T % self.sp:
            raise ValueError(f"sequence length {T} is not divisible by the "
                             f"{axis_name!r} axis size {self.sp}")
        dp = mesh.shape.get(batch_axis, 1) if batch_axis is not None else 1
        if B % dp:
            dp = 1          # batch too small to also shard over data
        self.B_loc, self.T_loc = B // dp, T // self.sp
        self.mesh = mesh
        self.rings, self.coords = [], []
        for b in range(dp):
            at = {batch_axis: b} if dp > 1 else {}
            self.coords.append([{**at, axis_name: s}
                                for s in range(self.sp)])
            self.rings.append([mesh.device(c) for c in self.coords[-1]])

    def streams(self):
        """Per ring, the stream of each ring position (``streams_at``:
        None on a shared device), each waiting for its device's current
        stream (the split inputs)."""
        return [self.mesh.streams_at(cs) for cs in self.coords]

    def split(self, x):
        """Per ring, per ring position: the shard of ``x`` on its device."""
        Bl, Tl = self.B_loc, self.T_loc
        return [[x[b * Bl:(b + 1) * Bl, :, s * Tl:(s + 1) * Tl].to(dev)
                 for s, dev in enumerate(devs)]
                for b, devs in enumerate(self.rings)]

    @staticmethod
    def join(parts, device, streams):
        """The inverse of ``split``, gathered on ``device``'s current
        stream once it has waited for every shard's stream."""
        for ring, ps in zip(streams, parts):
            join(ring, ps)
        return torch.cat([torch.cat([p.to(device) for p in ring], dim=2)
                          for ring in parts], dim=0)


def _forward(q, k, v, layout, sm_scale, causal, impl):
    """Global (o, lse), gathered on q's device."""
    parts = [layout.split(t) for t in (q, k, v)]
    streams = layout.streams()
    outs = [_ring_forward(qr, kr, vr, sm_scale, causal, impl, sr)
            for qr, kr, vr, sr in zip(*parts, streams)]
    return (layout.join([o for o, _ in outs], q.device, streams),
            layout.join([lse for _, lse in outs], q.device, streams))


class _RingAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX ring: the ring forward, and the second
    ring pass as its backward, both per block through the kernels on a card
    (``flash_fwd_lse``, ``flash_bwd_lse``) or the plain versions, as
    ``impl`` says."""

    @staticmethod
    def forward(ctx, q, k, v, layout, sm_scale, causal, impl):
        o, lse = _forward(q, k, v, layout, sm_scale, causal, impl)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (layout, sm_scale, causal, impl)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        layout, sm_scale, causal, impl = ctx.args
        parts = [layout.split(t) for t in (q, k, v, o, lse, g)]
        streams = layout.streams()
        grads = [_ring_bwd_pass(*ring, sm_scale, causal, impl, sr)
                 for *ring, sr in zip(*parts, streams)]
        dq, dk, dv = (layout.join([ring[j] for ring in grads], t.device,
                                  streams)
                      for j, t in enumerate((q, k, v)))
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, mesh: Mesh, axis_name: str = "sequence",
                   causal: bool = False, sm_scale: Optional[float] = None,
                   batch_axis: Optional[str] = "data", impl: str = "auto"):
    """Exact attention with the sequence dim sharded over ``axis_name``.

    q, k, v: ``(B, H, T, D)`` global tensors (T divisible by the axis
    size); B is also split over ``batch_axis`` when it divides by that
    axis's size.  Returns the ``(B, H, T, D)`` result on q's device;
    differentiable in q, k and v (the ring backward, see the module
    docstring).

    ``impl``: ``"cuda"`` (or the JAX package's ``"pallas"``, whose
    backward is jnp) launches the kernels ``flash_fwd_lse`` and, in the
    backward, ``flash_bwd_lse`` for each visible block, and raises for
    shards not on a card; ``"plain"`` (or ``"jnp"``) runs
    ``_reference_attention_with_lse`` and ``_block_grads``' plain body per
    block with the causal shift; ``"auto"`` takes the kernels for shards on
    a CUDA device and the plain blocks elsewhere.
    """
    impl = JAX_IMPLS.get(impl, impl)
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or "
                         f"{tuple(JAX_IMPLS)}, got {impl!r}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    layout = _Layout(mesh, axis_name, batch_axis, q.shape[0], q.shape[2])
    return _RingAttention.apply(q, k, v, layout, float(sm_scale),
                                bool(causal), impl)
