"""The per-position data-parallel step: each data position of a mesh on its
own device, under its own CUDA stream.

The JAX package drives every local chip from one process: its step is
compiled with data-sharded inputs (``estimator.py:596-599``), so each
device computes the forward and backward on its rows and GSPMD reduces
the gradients.  ``Positions`` is the port's counterpart, the step the
estimator runs when its mesh's positions lie on more than one device (a
mesh over several cards), and on one device when asked to by the
estimator's private selector (how the tests hold it on the CPU and the
smoke run on one card):

- Each data position holds a replica of the module's parameters and
  buffers on its device (position 0's are the module's own), and under
  mixed precision a bf16 shadow of them.
- A step runs position ``i``'s forward, loss and backward on its rows of
  the global batch, under its stream (``Mesh.stream``; autograd runs each
  backward op on its forward op's stream), inside
  ``parallel.distributed.position_scope``, so the hash dropout and the
  attention kernels draw its rows of the global masks.  Under
  ``grad_accum_steps=N`` a position takes its rows of each of the N
  microbatches (the JAX split: microbatch ``j`` is rows ``[j*B/N,
  (j+1)*B/N)`` of the global batch) and averages its gradients in f32
  (mixed precision) or the parameters' dtype.
- The data positions are this process's first position of each of its
  data coordinates: positions that differ only along "model",
  "sequence", "expert" or "pipeline" hold the same rows and replica (the
  JAX semantics: the batch is sharded over "data" alone), so a row block
  is computed once for such a group and its updated weights copied to
  the group's other positions.
- Under a "model" axis above 1 (``shard_model``), the master weights
  are placed by the Megatron rules (``parallel/sharding.py``): each
  position holds its block on its device.  A data position still runs
  its forward and backward on a whole replica (what GSPMD's program
  computes, up to the order of sums), its attention split over its row
  of (data, model) blocks, each on that position's device
  (``sharded_flash_attention`` inside the position's scope).  So a data
  position's device holds a whole f32 replica (and a bf16 shadow) beside
  its master block: the model axis splits the masters and the slots, not
  the weights a position computes with, and saves no weight memory there
  (``bytes_per_device`` of the masters counts the blocks only).
- Every leaf's update blocks (``parallel.zero``'s specs under ZeRO,
  composed with the Megatron ones; else the masters' blocks) have one
  owner, the first position holding the block.  The owner adds the data
  positions' gradients of its block in position order
  (``mesh.reduce_ordered``: the same bits on every run, whichever device
  holds which part) and divides by their number; the loss is the
  positions' mean losses averaged in the same order.  Clipping by value
  acts on each block, clipping by global norm adds the blocks' squared
  norms in the plan's order.
- Each block is updated on its owner's device (``update_blocks``, whose
  slots live there), and the updated block is copied into every other
  master shard and replica that holds it (``mesh.broadcast_from``).  So
  without ZeRO and a model axis position 0 updates everything; with ZeRO
  each position updates its share.

Streams: at the start of a step each position's stream waits for its
device's current stream (``fork``), and the reduction, the update and the
copies run on the current streams after they wait for every position's
stream (``join``); a tensor one stream made and another reads is marked
for the reader (``used_on``).  On the host there are no streams and the
positions run one after another.

``predict`` splits a batch into the positions' row blocks (a ragged batch
zero-padded up to their multiple) and joins the outputs in row order on
position 0's device.

Inside each process of a job (a mesh over several processes, each
holding some of its positions, ``Mesh.data_groups``), the step runs
this process's data positions as above on its rows of the global batch
(the featureset's rows of its data coordinates; under accumulation the
global batch is gathered first, one all-gather a leaf, and each
position takes its rows of every global microbatch).  The positions'
whole gradients are added in position order on position 0's device,
then summed over the processes, each data group counted once, and
divided by the data axis's size (``Estimator._across``: one all-reduce
a dtype).  Each process updates the blocks its positions hold (a block
several processes hold is updated alike by each, from the same gradient
and slots) and copies them into its own master shards and replicas; the
blocks it lacks (a model group or a ZeRO split across processes) come
from their owners, the lowest process holding each, by one all-gather a
dtype (``exchange``).  Norms over a whole leaf or tree add each block's
squares once, in its owner (``cross``).

Such a step runs eager (no CUDA graph).  BatchNormalization's statistics
stay each position's own, as each process's do; the module's buffers are
position 0's.  A job whose processes the port does not split a batch
over (``Mesh.data_groups``) raises ``NotImplementedError`` naming ROADMAP
Queue 1 item 5.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.func import functional_call

from analytics_zoo_tpu_torch.data.featureset import tree_leaves, tree_map
from analytics_zoo_tpu_torch.keras import optimizers as optim_mod
from analytics_zoo_tpu_torch.ops.dropout import derive_seed
from analytics_zoo_tpu_torch.parallel.distributed import position_scope
from analytics_zoo_tpu_torch.parallel.mesh import (
    Mesh, NamedSharding, ShardedTensor, block_table, broadcast_from,
    exchange, fork, join, on_stream, reduce_ordered, used_on, _dev_key,
    _key)


def rows_of(leaf, start: int, n: int, device) -> torch.Tensor:
    """Rows ``[start, start + n)`` of a global batch leaf on ``device``:
    a tensor's rows, or those of the one shard of a batch placed over the
    data axis (``ShardedTensor``) that holds them."""
    if isinstance(leaf, ShardedTensor):
        blk = leaf.sharding.shard_shape(leaf.shape)[0]
        k = start // blk
        if (start + n - 1) // blk != k:
            raise ValueError(f"rows [{start}, {start + n}) span two data "
                             f"blocks of {blk} rows")
        t = leaf.shard({"data": k})
        if t is None:           # held at another model coordinate here
            mesh = leaf.sharding.mesh
            t = next(leaf.shards[p] for p in mesh.local_positions
                     if mesh.coords(p).get("data", 0) == k)
        t = t[start - k * blk:start - k * blk + n]
    else:
        t = leaf[start:start + n]
    return t.to(device, non_blocking=True)


def _owner_place(full: torch.Tensor, sharding: NamedSharding, devs,
                 positions) -> ShardedTensor:
    """``full`` placed by ``sharding``, each distinct block (by its
    slices) once, on the device of the first position holding it; the
    other holders share that tensor."""
    made: Dict[tuple, torch.Tensor] = {}
    shards: List[Optional[torch.Tensor]] = [None] * sharding.mesh.size
    for i, p in enumerate(positions):
        slices = sharding.index(p, full.shape)
        key = _key(slices)
        if key not in made:
            made[key] = full[slices].to(devs[i], copy=True).contiguous()
        shards[p] = made[key]
    return ShardedTensor(shards, full.shape, sharding)


class Positions:
    """The replicas, streams and update plan of the per-position step of
    ``est`` (an ``Estimator``) over ``mesh``: its data positions (this
    process's first position of each of its data coordinates) hold the
    replicas and run the step; every position may own update blocks."""

    def __init__(self, est, mesh: Mesh):
        self.est = est
        self.mesh = mesh
        first: Dict[int, int] = {}
        for p in mesh.local_positions:
            first.setdefault(mesh.coords(p).get("data", 0), p)
        #: this process's data coordinates (global) and their positions
        self.coords = sorted(first)
        self.positions = [first[d] for d in self.coords]
        self.data_size = mesh.shape.get("data", 1)
        self.group = mesh.group if mesh.process_count > 1 else None
        self.devs = [mesh.devices.flat[p] for p in self.positions]
        self.streams = [mesh.stream(p) for p in self.positions]
        self.n = len(self.positions)
        if _dev_key(est.device) != _dev_key(self.devs[0]):
            raise ValueError(f"the model's device {est.device} is not the "
                             f"first position's {self.devs[0]}")
        model = est.model
        self.trainable = [n for n, p in model.named_parameters()
                          if p.requires_grad]
        own = dict(model.named_parameters())
        own.update(model.named_buffers())
        # position i's tensors for functional_call: 0 is the module's own
        self.tensors: List[Dict[str, torch.Tensor]] = [own]
        for dev in self.devs[1:]:
            self.tensors.append({
                k: t.detach().to(dev, copy=True).requires_grad_(
                    t.requires_grad) for k, t in own.items()})
        self.shadows: Optional[List[Dict[str, torch.Tensor]]] = None
        if est.mixed_precision:
            self.shadows = [est._shadow(self._weights(i))
                            for i in range(self.n)]
        self.entries: List[Tuple[str, tuple, int]] = []
        self.masters: Dict[str, ShardedTensor] = {}
        self._own_shards: List[Tuple[torch.Tensor, tuple, str]] = []
        # over processes: the blocks this process lacks (their exchange
        # entries by dtype, and where each lands), and the norms' cross
        self.remote: Dict[torch.dtype, tuple] = {}
        self.after: List[Tuple[torch.Tensor, List[torch.Tensor]]] = []
        self.cross = None

    def _weights(self, i: int) -> Dict[str, torch.Tensor]:
        """Position ``i``'s trainable tensors (its replica's)."""
        return {n: self.tensors[i][n] for n in self.trainable}

    # ------------------------------------------------------------ placement
    def _place_masters(self, psh: Dict[str, NamedSharding]) -> None:
        """Every parameter as a ``ShardedTensor`` placed by ``psh``: a
        data position whose block is the whole leaf holds its replica,
        every other position a block of its own on its device (one tensor
        for the positions of one device that hold the same block)."""
        mesh = self.mesh
        replica_at = dict(zip(self.positions, range(self.n)))
        for name, p in self.est.model.named_parameters():
            shape = tuple(p.shape)
            shards: List[Optional[torch.Tensor]] = [None] * mesh.size
            made: Dict[tuple, torch.Tensor] = {}
            for q in mesh.local_positions:
                slices = psh[name].index(q, shape)
                i = replica_at.get(q)
                if i is not None and _whole(slices, shape):
                    shards[q] = self.tensors[i][name].detach()
                    continue
                key = (str(mesh.devices.flat[q]), _key(slices))
                if key not in made:
                    made[key] = p.detach()[slices].to(
                        mesh.devices.flat[q], copy=True).contiguous()
                    self._own_shards.append((made[key], slices, name))
                shards[q] = made[key]
            self.masters[name] = ShardedTensor(shards, shape, psh[name])

    def place(self, opt_tree: dict, psh: Dict[str, NamedSharding],
              gsh: Dict[str, NamedSharding], osh: dict,
              slot_names) -> dict:
        """The masters placed by ``psh``, the optimizer state's tensors
        ``opt_tree`` by ``osh``, each slot block once on its owner's
        device (the first position holding it; the counts on position
        0's), and the plan: for each trainable leaf, each distinct block
        of its update sharding ``gsh`` in position order, its owner, and
        the master shards and replica views the updated block is copied
        into (the estimator's ``_shardings`` gives the three).  Returns
        the placed state."""
        mesh = self.mesh
        self._place_masters(psh)
        self.entries = []
        for n in self.trainable:
            shape = tuple(self.masters[n].shape)
            seen = set()
            for q in mesh.local_positions:
                slices = gsh[n].index(q, shape)
                if _key(slices) not in seen:
                    seen.add(_key(slices))
                    self.entries.append((n, slices, q))
        devs = [mesh.devices.flat[q] for q in mesh.local_positions]
        placed = {}
        for k, v in opt_tree.items():
            if isinstance(v, dict):
                placed[k] = {n: _owner_place(v[n], osh[k][n], devs,
                                             mesh.local_positions)
                             for n in v}
            else:
                placed[k] = _owner_place(v, osh[k], devs,
                                         mesh.local_positions)
        self.slots = {k: [_held(placed[k][n], slices, q)
                          for n, slices, q in self.entries]
                      for k in slot_names}
        self.names = [n for n, _, _ in self.entries]
        self.ps = [_held(self.masters[n], slices, q)
                   for n, slices, q in self.entries]
        self.copies = [self._copies(j) for j in range(len(self.entries))]
        self.groups = [[j for j, m in enumerate(self.names) if m == n]
                       for n in self.trainable]
        if self.group is not None:
            self._plan_remote(gsh)
        return placed

    def _plan_remote(self, gsh: Dict[str, NamedSharding]) -> None:
        """Over processes: each update block that some process lacks is
        sent by its owner, the lowest process holding it, after the
        update (``exchange``, one all-gather a dtype) into this process's
        replicas and master shards where it lacks it; a block several
        processes hold is updated by each (the same gradient and slots)
        and counted, in a norm over a whole leaf or tree, by its owner
        alone (``cross``)."""
        me, size = self.group.rank, self.group.size
        at = {(n, _key(sl)): j for j, (n, sl, _) in enumerate(self.entries)}
        owned = [False] * len(self.entries)
        for n in self.trainable:
            master = self.masters[n]
            like = self.tensors[0][n].detach()
            for slices, holders, p in block_table(gsh[n], master.shape):
                owner = min(holders)
                j = at.get((n, _key(slices)))
                if j is not None:
                    owned[j] = owner == me
                if len(holders) == size:
                    continue
                dst = None
                if p < 0:
                    dst = like[slices]
                    views = [_held(master, slices, q)
                             for q in self.mesh.local_positions
                             if _holds(master, slices, q)]
                    views += [t[n].detach()[slices] for t in self.tensors]
                    seen, out = {_memory(dst)}, []
                    for v in views:
                        if _memory(v) not in seen:
                            seen.add(_memory(v))
                            out.append(v)
                    self.after.append((dst, out))
                _, entries = self.remote.setdefault(like.dtype, (like, []))
                entries.append((owner, math.prod(
                    sl.stop - sl.start for sl in slices),
                    self.ps[j] if owner == me else None, dst))
        if self.remote:
            self.cross = (owned, self.group.all_reduce)

    def _exchange(self) -> None:
        """The updated blocks this process lacks, from their owners, into
        its replicas and master shards."""
        for like, entries in self.remote.values():
            exchange(entries, self.group, like)
        for dst, views in self.after:
            broadcast_from(dst, views)

    def _copies(self, j: int) -> List[torch.Tensor]:
        """Where entry ``j``'s updated block goes: every other master
        shard and every replica that holds it (each memory once)."""
        n, slices, owner = self.entries[j]
        master = self.masters[n]
        views = [_held(master, slices, q) for q in self.mesh.local_positions
                 if _holds(master, slices, q)]
        views += [t[n].detach()[slices] for t in self.tensors]
        out, seen = [], {_memory(self.ps[j])}
        for v in views:
            if _memory(v) not in seen:
                seen.add(_memory(v))
                out.append(v)
        return out

    @torch.no_grad()
    def refresh(self) -> None:
        """Position 0's tensors (the module's: the truth between calls)
        into every other replica and master shard."""
        for i in range(1, self.n):
            for k, t in self.tensors[i].items():
                t.copy_(self.tensors[0][k])
        for t, slices, name in self._own_shards:
            t.copy_(self.tensors[0][name].detach()[slices])

    # ----------------------------------------------------------------- step
    def _forward(self, i: int, fwd, x, seed):
        """Position ``i``'s predictions (f32) from the weights ``fwd`` and
        its replica, in its dropout position and the estimator's layer
        context (entered here, so that a recomputation in the backward,
        on autograd's thread, sees them too)."""
        with position_scope(i, self.n), self.est._scope():
            return self.est._forward(fwd, x, seed, self.tensors[i])

    def _position_grads(self, i: int, x, y, seed, starts: List[int],
                        per: int):
        """Position ``i``'s mean loss and gradients over its ``per`` rows
        at ``starts[j]`` of the batch, one start a microbatch
        (accumulated as the estimator's step does), on its device."""
        est = self.est
        dev, acc_n = self.devs[i], est.grad_accum_steps
        fwd = est._fwd_weights(self._weights(i), self.shadows[i]
                               if self.shadows is not None else None)
        losses, acc = [], None
        for j, start in enumerate(starts):
            xi = tree_map(lambda a: rows_of(a, start, per, dev), x)
            yi = tree_map(lambda a: rows_of(a, start, per, dev), y)
            if est._fused_tf is not None:
                xi = est._fused_tf.apply_jax(xi)
            sj = seed if acc_n == 1 or seed is None else derive_seed(seed, j)
            loss, g = est._grads(fwd, xi, yi, sj, forward=lambda xx: (
                self._forward(i, fwd, xx, sj)))
            losses.append(loss.detach())
            if acc_n == 1:
                return loss.detach(), g
            with torch.no_grad():
                acc = est._add_grads(acc, g)
        torch._foreach_div_(acc, float(acc_n))
        return torch.stack(losses).mean(), acc

    def _starts(self, x, per: int, gathered: bool) -> List[List[int]]:
        """Each position's first row of each microbatch in ``x``'s rows:
        microbatch ``j`` is rows ``[j*B/N, (j+1)*B/N)`` of the global
        batch of B rows and data coordinate ``c`` holds its ``per`` rows
        from ``c * per`` on; a placed leaf (``ShardedTensor``) and a
        gathered global batch index global rows, a tensor of this
        process's rows its own."""
        mb = per * self.data_size
        local = not gathered and not isinstance(tree_leaves(x)[0],
                                                ShardedTensor)
        shift = self.coords[0] * per if local else 0
        return [[j * mb + (c * per) - shift
                 for j in range(self.est.grad_accum_steps)]
                for c in self.coords]

    def _global(self, tree):
        """Every leaf's global batch, gathered on position 0's device:
        this process's rows (in coordinate order), all-gathered, and the
        data groups' parts (their lowest processes') in group order."""
        mesh, dev = self.mesh, self.devs[0]
        leaders = [g[0] for g in mesh.data_groups()]

        def leaf(a):
            if isinstance(a, ShardedTensor):
                blk = a.sharding.shard_shape(a.shape)[0]
                a = torch.cat([rows_of(a, c * blk, blk, dev)
                               for c in self.coords])
            parts = self.group.all_gather(a.to(dev).contiguous())
            return torch.cat([parts[q] for q in leaders])
        return tree_map(leaf, tree)

    def step(self, x, y, seed) -> torch.Tensor:
        """One optimizer step on the global batch ``(x, y)`` (tensors, or
        leaves placed over the data axis; over processes, this process's
        rows of it); returns the loss on position 0's device (no host
        read)."""
        est = self.est
        acc_n = est.grad_accum_steps
        lead = tree_leaves(x)[0]
        rows = (lead.shape[0] * self.n // self.data_size
                if isinstance(lead, ShardedTensor) else lead.shape[0])
        if rows % (acc_n * self.n):
            raise ValueError(
                f"batch_size {rows} must divide by grad_accum_steps * "
                f"data positions = {acc_n}*{self.n}")
        per = rows // (acc_n * self.n)
        gathered = self.group is not None and acc_n > 1
        if gathered:
            # microbatch j spans every process's rows: gather the batch
            x, y = self._global(x), self._global(y)
        starts = self._starts(x, per, gathered)
        fork(self.streams)
        losses, grads = [], []
        for i in range(self.n):
            with on_stream(self.streams[i]):
                for t in tree_leaves((x, y)):
                    if isinstance(t, torch.Tensor):
                        used_on([t], self.streams[i])
                loss, g = self._position_grads(i, x, y, seed, starts[i],
                                               per)
            losses.append(loss)
            grads.append(dict(zip(self.trainable, g)))
        join(self.streams, [*losses, *(t for g in grads for t in g.values())])
        with torch.no_grad():
            if self.group is None:
                loss = reduce_ordered([[v] for v in losses], self.devs[0],
                                      torch.float32)[0].div_(self.n)
                blocks = self._reduce(grads)
            else:
                loss, blocks = self._reduce_across(losses, grads)
            est._clip(blocks, self.cross)
            est.optimizer.update_blocks(optim_mod.Blocks(
                self.names, self.ps, blocks, self.slots, self.groups,
                est.opt_state.get("decayed", ()), self.cross),
                est.opt_state)
            for src, dsts in zip(self.ps, self.copies):
                broadcast_from(src, dsts)
            if self.group is not None:
                self._exchange()
        return loss

    def _reduce(self, grads: List[Dict[str, torch.Tensor]]
                ) -> List[torch.Tensor]:
        """Each plan entry's gradient: the positions' blocks added on its
        owner's device in position order (in f32 under mixed precision),
        divided by their number, cast as the estimator's update takes
        it."""
        est = self.est
        wide = torch.float32 if est.mixed_precision else None
        out: List[Optional[torch.Tensor]] = [None] * len(self.entries)
        by_owner: Dict[int, List[int]] = {}
        for j, (_, _, q) in enumerate(self.entries):
            by_owner.setdefault(q, []).append(j)
        for q, idx in by_owner.items():
            parts = [[g[self.entries[j][0]][self.entries[j][1]] for j in idx]
                     for g in grads]
            dtypes = {p.dtype for p in parts[0]}
            summed: List[Optional[torch.Tensor]] = [None] * len(idx)
            for dt in dtypes:
                sel = [k for k, p in enumerate(parts[0]) if p.dtype == dt]
                got = reduce_ordered([[p[k] for k in sel] for p in parts],
                                     self.mesh.devices.flat[q],
                                     wide if dt.is_floating_point else dt)
                torch._foreach_div_(got, float(self.n))
                for k, t in zip(sel, got):
                    summed[k] = t
            for j, t in zip(idx, est._cast_grads(summed)):
                out[j] = t
        return out

    def _reduce_across(self, losses, grads):
        """Over processes, the loss and each plan entry's gradient: the
        local positions' losses and whole gradients added in position
        order on position 0's device (the gradients in f32 under mixed
        precision), then summed over the processes, each data group
        counted once, and divided by the data positions
        (``Estimator._across``: one all-reduce a dtype), cut into the
        plan's blocks on their owners' devices and cast as the update
        takes them."""
        est = self.est
        dev = self.devs[0]
        loss = reduce_ordered([[v] for v in losses], dev, torch.float32)[0]
        full = reduce_ordered(
            [[g[n] for n in self.trainable] for g in grads], dev,
            torch.float32 if est.mixed_precision else None)
        loss, full = est._across(loss, full, self.data_size)
        by_name = dict(zip(self.trainable, full))
        return loss, est._cast_grads([
            by_name[n][slices].to(self.mesh.devices.flat[q])
            for n, slices, q in self.entries])

    # -------------------------------------------------------------- predict
    def predict(self, x):
        """The model's outputs for the batch ``x`` (eval mode), each
        position computing its row block on its stream, joined in row
        order on position 0's device; a batch the positions do not divide
        is zero-padded up to their multiple and the padding dropped."""
        rows = tree_leaves(x)[0].shape[0]
        pad = -rows % self.n
        if pad:
            x = tree_map(lambda a: torch.cat(
                [a, a.new_zeros((pad,) + tuple(a.shape[1:]))]), x)
        per = (rows + pad) // self.n
        fork(self.streams)
        outs = []
        for i in range(self.n):
            with on_stream(self.streams[i]):
                for t in tree_leaves(x):
                    used_on([t], self.streams[i])
                xi = tree_map(lambda a: rows_of(a, i * per, per,
                                                self.devs[i]), x)
                with position_scope(i, self.n):
                    outs.append(functional_call(self.est.model,
                                                self.tensors[i], (xi,)))
        join(self.streams, tree_leaves(outs))
        dev = self.devs[0]
        first = outs[0]
        if isinstance(first, torch.Tensor):
            return torch.cat([o.to(dev) for o in outs])[:rows]
        return type(first)(torch.cat([o[k].to(dev) for o in outs])[:rows]
                           for k in range(len(first)))


def _holds(placed: ShardedTensor, slices, q: int) -> bool:
    """Whether position ``q``'s shard of ``placed`` holds all of
    ``slices``."""
    held = placed.sharding.index(q, placed.shape)
    return all(h.start <= s.start and s.stop <= h.stop
               for s, h in zip(slices, held))


def _held(placed: ShardedTensor, slices, q: int) -> torch.Tensor:
    """Position ``q``'s view of ``slices`` in its shard of ``placed``."""
    if not _holds(placed, slices, q):
        raise ValueError(f"position {q} holds no block {slices} of "
                         f"{placed}")
    held = placed.sharding.index(q, placed.shape)
    t = placed.shards[q]
    rel = tuple(slice(s.start - h.start, s.stop - h.start)
                for s, h in zip(slices, held))
    return t if _whole(rel, t.shape) else t[rel]


def _memory(t: torch.Tensor) -> tuple:
    return (str(t.device), t.data_ptr(), tuple(t.shape), t.stride())


def _whole(slices, shape) -> bool:
    return all(s.start == 0 and s.stop == n for s, n in zip(slices, shape))
