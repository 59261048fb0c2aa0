"""Mixture-of-Experts with expert parallelism over the "expert" mesh axis.

Port of ``analytics_zoo_tpu/parallel/moe.py``: the GShard / Switch
formulation, top-1 gating with a capacity limit, routing and dispatch as
dense einsums, so every shape is static.  Tokens over an expert's
capacity are dropped (their output is the zero vector; a residual
connection carries them through).

With a mesh whose ``axis`` is above 1, the experts are split into that
many contiguous groups and group ``s`` runs on the device at coordinate
``s`` (over several devices, ``Mesh.block_streams``, on that position's
stream, so the groups overlap; on a shared device one after another on
its current stream): its slice
of the ``(E, C, d)`` dispatched tokens moves there, its two GEMMs run
there next to its weights, and its outputs move back to the tokens'
device for the combine once that device's stream has waited for the
groups' (the port's single-controller form of the all-to-all XLA
inserts).  Differentiable through autograd.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.parallel.mesh import (
    Mesh, NamedSharding, PartitionSpec as P, ShardedTensor, join, on_stream,
    used_on)


def _gelu(x):
    # jax.nn.gelu, the JAX default, is the tanh approximation
    return F.gelu(x, approximate="tanh")


def init_moe_params(generator: Optional[torch.Generator], d_model: int,
                    d_ff: int, num_experts: int, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Router + per-expert FFN weights, drawn from ``generator`` (seed 0
    when None) as the JAX package draws them (normal, scaled by
    ``1/sqrt(fan_in)``; zero biases).  Leaves carry a leading E dim so the
    "expert" axis splits them one group of experts per position
    (``partition_moe_params``).  ``device=None`` means the card."""
    from analytics_zoo_tpu_torch.common.context import resolve_device
    device = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(0)
    randn = lambda *shape: torch.randn(shape, generator=gen,
                                       dtype=torch.float32)
    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(d_ff)
    params = {
        "router": randn(d_model, num_experts) * scale_in,
        "W1": randn(num_experts, d_model, d_ff) * scale_in,
        "b1": torch.zeros(num_experts, d_ff),
        "W2": randn(num_experts, d_ff, d_model) * scale_out,
        "b2": torch.zeros(num_experts, d_model),
    }
    return {k: v.to(device=device, dtype=dtype) for k, v in params.items()}


def partition_moe_params(mesh: Mesh, axis: str = "expert"):
    """``NamedSharding``s for an ``init_moe_params`` tree: experts split
    over ``axis``, router replicated."""
    ex = lambda *rest: NamedSharding(mesh, P(axis, *rest))  # noqa: E731
    return {
        "router": NamedSharding(mesh, P()),
        "W1": ex(None, None), "b1": ex(None),
        "W2": ex(None, None), "b2": ex(None),
    }


def _group(w, s: int, groups: int, axis: str, device) -> torch.Tensor:
    """Expert group ``s`` of a leaf with a leading E dim, on ``device``:
    the shard at ``{axis: s}`` of a placed leaf, else a slice."""
    if isinstance(w, ShardedTensor):
        return w.shard({axis: s}).to(device)
    n = w.shape[0] // groups
    return w[s * n:(s + 1) * n].to(device)


def _whole(w, device) -> torch.Tensor:
    return w.gather(device) if isinstance(w, ShardedTensor) else w


def _experts(expert_in, W1, b1, W2, b2, activation):
    h = activation(torch.einsum("ecd,edf->ecf", expert_in, W1)
                   + b1[:, None, :])
    return torch.einsum("ecf,efd->ecd", h, W2) + b2[:, None, :]


def moe_ffn(params, x, *, capacity_factor: float = 1.25,
            mesh: Optional[Mesh] = None, axis: str = "expert",
            activation: Callable = _gelu
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-style MoE FFN.

    x: (..., d_model); leading dims are flattened to a token axis.
    Returns (y, aux_loss): y has x's shape; aux_loss is the
    load-balancing loss (Switch eq. 4), for the caller to add to its loss.
    """
    E = params["W1"].shape[0]
    d = x.shape[-1]
    lead = x.shape[:-1]
    tokens = x.reshape(-1, d)                              # (N, d)
    N = tokens.shape[0]
    C = max(1, int(capacity_factor * N / E))               # per-expert slots

    logits = tokens @ _whole(params["router"], x.device)   # (N, E)
    gates = torch.softmax(logits, dim=-1)
    expert_idx = gates.argmax(dim=-1)                      # (N,)
    onehot = F.one_hot(expert_idx, E).to(x.dtype)          # (N, E)
    gate_val = (gates * onehot).sum(dim=-1)                # (N,)

    # Switch load-balancing aux loss: E * sum_e f_e * p_e
    density = onehot.mean(dim=0)
    density_proxy = gates.mean(dim=0)
    aux_loss = E * (density * density_proxy).sum()

    # position of each token within its expert's capacity (0-based)
    pos = torch.cumsum(onehot, dim=0) * onehot             # 1-based if kept
    pos_tok = pos.sum(dim=-1).to(torch.int32) - 1          # (N,)
    keep = (pos_tok >= 0) & (pos_tok < C)
    # one_hot of pos_tok over C slots, zero where it lies outside [0, C)
    slot = (pos_tok[:, None] == torch.arange(
        C, dtype=torch.int32, device=x.device)).to(x.dtype)
    dispatch = (onehot * keep[:, None])[:, :, None] * slot[:, None, :]

    expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens)
    groups = mesh.shape.get(axis, 1) if mesh is not None else 1
    names = ("W1", "b1", "W2", "b2")
    if groups > 1:
        if E % groups:
            raise ValueError(f"{E} experts do not divide over the "
                             f"{groups}-way '{axis}' axis")
        n = E // groups
        streams = mesh.streams_at([{axis: s} for s in range(groups)])
        outs = []
        for s in range(groups):
            dev = mesh.device({axis: s})
            with on_stream(streams[s]):
                used_on([expert_in], streams[s])
                w = [_group(params[k], s, groups, axis, dev) for k in names]
                outs.append(_experts(expert_in[s * n:(s + 1) * n].to(dev),
                                     *w, activation).to(x.device))
        join(streams, outs)
        expert_out = torch.cat(outs, dim=0)
    else:
        expert_out = _experts(expert_in,
                              *(_whole(params[k], x.device) for k in names),
                              activation)

    combine = dispatch * gate_val[:, None, None]           # (N, E, C)
    y = torch.einsum("nec,ecd->nd", combine, expert_out)
    return y.reshape(*lead, d), aux_loss
