"""Pipeline parallelism over the "pipeline" mesh axis.

Port of ``analytics_zoo_tpu/parallel/pipeline.py``: the GPipe schedule.
Stage s's parameters live on the device at pipeline coordinate s (leaves
carry a leading S dim), and M microbatches stream through the stages in
``M + S - 1`` ticks: at tick t stage s runs microbatch ``t - s``, and its
output moves to stage s + 1's device with ``.to()`` for the next tick
(the JAX package's ``ppermute``).  Over several devices
(``Mesh.block_streams``) each stage runs on its position's stream
(``Mesh.stream``), after waiting for its predecessor's, so the stages of
one tick overlap; stages that share a device run on its current stream.  The schedule is differentiable through
autograd, so a pipelined training step is the backward of a loss through
``pipeline_apply``.

Constraint: every stage maps (mb, ...) -> (mb, ...) with the same shape
(the transformer-block case); heads and embeddings run outside.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch

from analytics_zoo_tpu_torch.parallel.mesh import (
    Mesh, ShardedTensor, join, on_stream, tree_leaves, tree_map, used_on)


def stack_stage_params(per_stage_params) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with leading S dim."""
    return tree_map(
        lambda *leaves: torch.stack([torch.as_tensor(l) for l in leaves]),
        *per_stage_params)


def _stage_params(stacked, s: int, axis: str, device):
    def leaf(a):
        if isinstance(a, ShardedTensor):
            a = a.shard({axis: s})
            return (a[0] if a.shape[0] == 1 else a[s]).to(device)
        return a[s].to(device)
    return tree_map(leaf, stacked)


def pipeline_apply(stage_fn: Callable, stacked_params, x, *, mesh: Mesh,
                   n_microbatches: int, axis: str = "pipeline",
                   data_axis: str = "data"):
    """Run ``x`` through S pipeline stages of ``stage_fn``.

    stage_fn(params, x_mb) -> y_mb, shape-preserving.
    stacked_params: tree with leading dim S (``stack_stage_params``);
      tensors (stage s's slice moves to its device) or ``ShardedTensor``s
      split over ``axis``.
    x: (B, ...) global batch; B must divide into ``n_microbatches``.
    Returns (B, ...) outputs on x's device.  When the mesh has a
    ``data_axis`` that divides the microbatch size, each microbatch is
    also split over it, and data shard d runs its own pipeline on the
    devices at data coordinate d (dp x pp).
    """
    S = mesh.shape[axis]
    n_stage = tree_leaves(stacked_params)[0].shape[0]
    if n_stage != S:
        raise ValueError(
            f"stacked params have {n_stage} stages but mesh axis "
            f"'{axis}' has size {S}")
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by n_microbatches "
                         f"{n_microbatches}")
    M = n_microbatches
    mbs = x.reshape(M, B // M, *x.shape[1:])
    dp = mesh.shape.get(data_axis, 1) if data_axis in mesh.axis_names else 1
    shard_data = dp > 1 and (B // M) % dp == 0
    parts = dp if shard_data else 1
    rows = (B // M) // parts

    columns = []
    for d in range(parts):
        coords = ({data_axis: d} if data_axis in mesh.axis_names else {})
        at = [{**coords, axis: s} for s in range(S)]
        devs = [mesh.device(c) for c in at]
        params = [_stage_params(stacked_params, s, axis, devs[s])
                  for s in range(S)]
        streams = mesh.streams_at(at)
        outs: List[Any] = [None] * M
        buf: List[Any] = [None] * S     # the input waiting at each stage
        for t in range(M + S - 1):
            # last stage first, so a stage reads what its predecessor
            # made at the previous tick
            for s in reversed(range(S)):
                m = t - s
                if not 0 <= m < M:
                    continue
                with on_stream(streams[s]):
                    if s == 0:
                        used_on([mbs], streams[0])
                        x_in = mbs[m, d * rows:(d + 1) * rows].to(devs[0])
                    else:
                        # the predecessor's output of the previous tick
                        if streams[s] is not None:
                            streams[s].wait_stream(streams[s - 1])
                        x_in = buf[s]
                        used_on([x_in], streams[s])
                    y = stage_fn(params[s], x_in)
                    if s == S - 1:
                        outs[m] = y.to(x.device)
                    else:
                        buf[s + 1] = y.to(devs[s + 1])
        join(streams, outs)
        columns.append(torch.stack(outs))
    out = torch.cat(columns, dim=1) if parts > 1 else columns[0]
    return out.reshape(B, *x.shape[1:])
