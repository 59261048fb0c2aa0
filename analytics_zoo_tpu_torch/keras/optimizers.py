"""Optimizers, step for step the optax updates of the JAX package.

Port of ``analytics_zoo_tpu/keras/optimizers.py`` (SGD, Adam, Adamax,
Adagrad, Adadelta, RMSprop, AdamWeightDecay, LAMB, LARS, ``PolyWarmup``,
``LarsWarmupPoly``, ``default_decay_mask``).  The JAX package builds them
from optax; here each is written out as plain tensor ops
(``torch._foreach_*``, a few multi-tensor launches per step on the card)
that equal optax's step: the schedule is read at the count before the
step, Adam's moments are bias-corrected, ``eps`` sits outside the square
root, decoupled weight decay goes on the masked parameters, and the
update is ``p + (-lr) * u``.

Everything a step reads lives on the parameters' device, so a CUDA graph
can replay the step: the step count is a 0-d int32 tensor in the state
(optax's ``count``), and the learning rate and Adam's bias corrections
are computed from it on the device in f32, the betas rounded to f32 as
optax's are (``1 - b2**c`` at b2 = 0.999 moves by ~1e-5 relative with
that rounding alone).  Trust ratios and norms stay on the device too.  A
schedule is a function of that count tensor (or returns a constant).

As in optax the optimizer holds no state: ``init(params)`` returns it and
``update(params, grads, state)`` advances it and the parameters in place.
Parameters are a ``{dotted name: tensor}`` dict (``named_parameters``).
The state holds optax's counts: ``count`` (the schedule's, or Adam's) and,
for the optimizers whose optax chain counts twice (the Adam family's
``ScaleByAdamState`` and ``ScaleByScheduleState``), ``schedule_count``
beside it, so the state's bytes are optax's.

The sharded step (``Estimator(shard_optimizer=True)`` or Megatron-placed
weights) updates blocks of the parameters: ``update_blocks`` takes each
block's parameter view, gradient and slot tensors with its leaf's name
(the decay mask reads the name), and the blocks of each leaf
(``groups``), so a norm that spans a whole leaf (LAMB's and LARS's trust
ratios) sums the squares of its blocks' norms in block order.  Every other
operation is elementwise and gives a block what it gives the whole leaf.
The Adam family takes gradients of a lower precision than their
parameters (the bf16 gradient tree of ``Estimator(grad_dtype=
"bfloat16")``) as optax does, each product in the dtype optax gives it;
the other optimizers widen them to the parameter's dtype first.
``AdamWeightDecay(state_dtype="bfloat16")`` stores the first moment in
bf16 (optax's ``mu_dtype``); the second stays f32.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Union

import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], Union[torch.Tensor, float]]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A schedule's value as an f32 tensor on ``like``'s device (a
    constant is written by a fill kernel, never copied from the host)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32)
    return torch.full(like.shape, float(v), dtype=torch.float32,
                      device=like.device)


class Blocks:
    """The tensors of one update, entry ``i`` of each list belonging
    together: ``ps[i]`` a parameter or a block of one (a view, updated in
    place), ``gs[i]`` its gradient, ``slots[k][i]`` its block of optimizer
    slot ``k`` and ``names[i]`` its leaf's name; ``groups`` lists the
    entries of each leaf (None: every entry a whole leaf); ``decayed`` the
    names weight decay applies to.  ``cross``: where a leaf's blocks are
    split over processes, ``(owned, sum_over_processes)``: which entries
    this process counts in a leaf's norm (a block several processes hold
    counts once) and the all-reduce that adds the processes' sums."""

    __slots__ = ("names", "ps", "gs", "slots", "groups", "decayed", "cross")

    def __init__(self, names, ps, gs, slots, groups=None, decayed=(),
                 cross=None):
        self.names, self.ps, self.gs = list(names), list(ps), list(gs)
        self.slots = {k: list(v) for k, v in slots.items()}
        self.groups = groups
        self.decayed = set(decayed)
        self.cross = cross

    def decayed_idx(self) -> List[int]:
        return [i for i, n in enumerate(self.names) if n in self.decayed]


def _local(t):
    """A state counter as a tensor: a placed (replicated) counter's shard
    in this process."""
    return getattr(t, "local_shard", t)


class Optimizer:
    """An update rule with its learning-rate schedule."""

    #: whether ``_step`` takes the gradients in their own dtype (else
    #: widened to their parameters')
    raw_grads = False
    #: whether optax's chain keeps a second count (the schedule's beside
    #: Adam's): the state then holds ``schedule_count`` too.  Nothing
    #: reads it (optax's two counts are always equal); it is there so the
    #: state's layout and ``bytes_per_device`` are optax's
    counts_twice = False

    def __init__(self, schedule: Schedule, name: str = "optimizer"):
        self.schedule = schedule
        self.name = name

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        return _f32(self.schedule(count), count)

    def learning_rate(self, step: int) -> Optional[float]:
        """The schedule at ``step``, read on the host."""
        return float(self._lr(torch.tensor(int(step), dtype=torch.int32)))

    def learning_rates(self, steps) -> List[Optional[float]]:
        """The schedule at every step of ``steps`` in one evaluation."""
        return [float(v) for v in self._lr(
            torch.tensor(list(steps), dtype=torch.int32)).reshape(-1)]

    def init(self, params: Params) -> dict:
        device = next(iter(params.values())).device if params else None
        zero = lambda: torch.zeros((), dtype=torch.int32, device=device)
        counts = {"count": zero()}
        if self.counts_twice:
            counts["schedule_count"] = zero()
        return {**counts, **self._init(params)}

    @staticmethod
    def slot_names(state: dict) -> List[str]:
        """The state's per-parameter slots (its ``{name: tensor}``
        entries), in the state's order."""
        return [k for k, v in state.items() if isinstance(v, dict)]

    def update(self, params: Params, grads: Params, state: dict) -> None:
        """One step: ``params`` and ``state`` change in place, with no
        host read (a CUDA graph can replay it)."""
        names = list(params)
        self.update_blocks(Blocks(
            names, [params[n] for n in names], [grads[n] for n in names],
            {k: [state[k][n] for n in names]
             for k in self.slot_names(state)},
            decayed=state.get("decayed", ())), state)

    @torch.no_grad()
    def update_blocks(self, blocks: Blocks, state: dict) -> None:
        """One step over ``blocks`` (whole leaves, or blocks of them that
        together cover each leaf once), advancing ``state``'s counts."""
        if not self.raw_grads:
            blocks.gs = [g if g.dtype == p.dtype else g.to(p.dtype)
                         for g, p in zip(blocks.gs, blocks.ps)]
        count = _local(state["count"])
        lr = self._lr(count)                  # at the count before the step
        self._step(blocks, lr, count + 1)
        count.add_(1)
        if self.counts_twice:
            _local(state["schedule_count"]).add_(1)

    def _init(self, params: Params) -> dict:
        raise NotImplementedError

    def _step(self, b: Blocks, lr, count) -> None:
        raise NotImplementedError

    @staticmethod
    def _apply(ps, upd, lr) -> None:
        """optax's ``scale_by_learning_rate`` then ``apply_updates``:
        ``p + (-lr) * u``."""
        torch._foreach_add_(ps, torch._foreach_mul(upd, -lr))


def _weak(c: float, like: List[torch.Tensor]) -> float:
    """A Python constant as JAX's weak typing applies it to tensors of
    ``like``'s dtype: rounded to that dtype first (b1 = 0.9 multiplies a
    bf16 moment as 0.8984375)."""
    if not like or like[0].dtype == torch.float32:
        return c
    return _rounded(c, like[0].dtype)


@functools.lru_cache(maxsize=None)
def _rounded(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=dtype))


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """optax's ``1 - decay**count`` in f32 (decay rounded to f32)."""
    return 1.0 - torch.pow(decay, count.to(torch.float32))


def _leaf_norms(ts, idx, groups, cross=None) -> torch.Tensor:
    """The norm of the whole leaf of each entry ``i`` of ``idx``: the
    entry's own norm when it is a whole leaf, else the square root of the
    sum of the squared norms of its leaf's blocks, in block order (over
    processes, ``cross``: each process's sum of the blocks it counts,
    added by one all-reduce)."""
    norms = torch._foreach_norm([ts[i] for i in idx])
    if groups is None:
        return torch.stack(norms)
    at = {i: j for j, i in enumerate(idx)}
    if cross is not None:
        owned, reduce = cross
        zero = torch.zeros((), dtype=norms[0].dtype, device=norms[0].device)
        sums = torch.stack([
            torch.stack([norms[at[i]] for i in g if i in at and owned[i]]
                        or [zero]).square().sum() for g in groups])
        leaf = reduce(sums).sqrt()
        out = [None] * len(idx)
        for j, g in enumerate(groups):
            for i in g:
                if i in at:
                    out[at[i]] = leaf[j]
        return torch.stack(out)
    out: List[Optional[torch.Tensor]] = [None] * len(idx)
    for group in groups:
        members = [i for i in group if i in at]
        if not members:
            continue
        if len(members) == 1:
            leaf = norms[at[members[0]]]
        else:
            leaf = torch.stack([norms[at[i]] for i in members]) \
                .square().sum().sqrt()
        for i in members:
            out[at[i]] = leaf
    return torch.stack(out)


def _trust_scale_(upd, ps, idx, groups=None, coeff=1.0, eps=0.0,
                  cross=None) -> None:
    """optax's ``scale_by_trust_ratio`` on ``upd[i]`` for ``i`` in
    ``idx``: ``coeff * |p| / (|u| + eps)`` over each entry's whole leaf,
    1 where either norm is 0."""
    if not idx:
        return
    pn = _leaf_norms(ps, idx, groups, cross)
    un = _leaf_norms(upd, idx, groups, cross)
    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                        coeff * pn / (un + eps))
    torch._foreach_mul_([upd[i] for i in idx], list(ratio.unbind()))


class _SGD(Optimizer):
    """optax.sgd: ``trace`` (momentum, optionally Nesterov) then ``-lr``."""

    def __init__(self, schedule, momentum: float, nesterov: bool):
        super().__init__(schedule, "sgd")
        self.momentum = momentum
        self.nesterov = nesterov

    def _init(self, params):
        if not self.momentum:
            return {}
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    def _step(self, b, lr, count):
        ps, gs = b.ps, b.gs
        upd = gs
        if self.momentum:
            trace = b.slots["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, gs)           # g + m * t
            upd = trace
            if self.nesterov:
                upd = torch._foreach_add(gs, trace, alpha=self.momentum)
        self._apply(ps, upd, lr)


class _Adam(Optimizer):
    """optax.adam / adamw / lamb: bias-corrected moments,
    ``u = mu_hat / (sqrt(nu_hat) + eps)``, plus ``wd * p`` on the
    parameters ``decay_mask`` selects; LAMB then scales each tensor's
    update by its trust ratio.  ``mu_dtype`` is the stored first moment's
    dtype.  The arithmetic is optax's as XLA compiles it into the JAX
    step: each constant rounded to the dtype of the tensor it multiplies
    (b1 = 0.9 multiplies a bf16 moment as 0.8984375), a low-precision
    result rounded unless it feeds an f32 sum directly (then it is used
    unrounded), the bias-corrected moments, the update and the second
    moment in f32."""

    raw_grads = True
    counts_twice = True

    def __init__(self, schedule, b1, b2, eps, name, weight_decay=0.0,
                 decay_mask: Optional[Callable[[Params], Dict[str, bool]]]
                 = None, mu_dtype: Optional[torch.dtype] = None,
                 trust_ratio: bool = False):
        super().__init__(schedule, name)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay_mask = decay_mask
        self.mu_dtype = mu_dtype
        self.trust_ratio = trust_ratio

    def _init(self, params):
        decayed = []
        if self.weight_decay:
            mask = (self.decay_mask(params) if self.decay_mask is not None
                    else None)
            decayed = [n for n in params if mask is None or mask[n]]
        return {"mu": {n: torch.zeros_like(p, dtype=self.mu_dtype)
                       for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()},
                "decayed": decayed}

    def _step(self, b, lr, count):
        ps, gs = b.ps, b.gs
        b1, b2 = self.b1, self.b2
        f32 = torch.float32
        mu_store = b.slots["mu"]
        nu = b.slots["nu"]
        low_mu = bool(mu_store) and mu_store[0].dtype != f32
        low_g = bool(gs) and gs[0].dtype != f32
        wide = lambda ts: [t.float() for t in ts]
        bc1 = _bias_correction(b1, count)
        gmu = torch._foreach_mul(wide(gs) if low_g and not low_mu else gs,
                                 _weak(1.0 - b1, gs))
        if not low_mu:                      # an f32 moment, in place
            torch._foreach_mul_(mu_store, b1)
            torch._foreach_add_(mu_store, gmu)
            mu = mu_store
        elif low_g and mu_store[0].dtype == gs[0].dtype:
            # one low dtype: in place, each op rounding to it; the moment
            # is read unrounded into the f32 division
            torch._foreach_mul_(mu_store, _weak(b1, mu_store))
            torch._foreach_add_(mu_store, gmu)
            mu = wide(mu_store)
            bc1 = bc1.to(mu_store[0].dtype).float()
        else:
            # a low moment feeding an f32 sum is used unrounded, and stored
            # rounded after the step
            mu = wide(mu_store)
            torch._foreach_mul_(mu, _weak(b1, mu_store))
            torch._foreach_add_(mu, wide(gmu) if low_g else gmu)
        g2 = torch._foreach_mul(gs, gs)             # g**2 in g's dtype
        if low_g:
            g2 = wide(g2)
        torch._foreach_mul_(g2, _weak(1.0 - b2, gs))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        den = torch._foreach_div(nu, _bias_correction(b2, count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        idx = b.decayed_idx()
        if idx:
            torch._foreach_add_([upd[i] for i in idx], [ps[i] for i in idx],
                                alpha=self.weight_decay)
        if self.trust_ratio:
            _trust_scale_(upd, ps, list(range(len(ps))), b.groups,
                          cross=b.cross)
        if low_mu and not (low_g and mu_store[0].dtype == gs[0].dtype):
            for stored, m in zip(mu_store, mu):
                stored.copy_(m)
        self._apply(ps, upd, lr)


class _Adamax(Optimizer):
    """optax.adamax: ``nu = max(|g| + eps, b2 * nu)``,
    ``u = mu_hat / nu``."""

    counts_twice = True

    def __init__(self, schedule, b1, b2, eps):
        super().__init__(schedule, "adamax")
        self.b1, self.b2, self.eps = b1, b2, eps

    def _init(self, params):
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        return {"mu": zeros(), "nu": zeros()}

    def _step(self, b, lr, count):
        ps, gs = b.ps, b.gs
        mu, nu = b.slots["mu"], b.slots["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - self.b1)
        inf = torch._foreach_abs(gs)
        torch._foreach_add_(inf, self.eps)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_maximum_(nu, inf)
        upd = torch._foreach_div(mu, _bias_correction(self.b1, count))
        torch._foreach_div_(upd, nu)
        self._apply(ps, upd, lr)


class _Adagrad(Optimizer):
    """optax.adagrad: ``s += g**2`` from 0.1, ``u = g / sqrt(s + eps)``
    (optax's zero for ``s <= 0`` cannot occur: ``s`` starts at 0.1)."""

    initial_accumulator_value = 0.1

    def __init__(self, schedule, eps):
        super().__init__(schedule, "adagrad")
        self.eps = eps

    def _init(self, params):
        return {"sum_of_squares": {
            n: torch.full_like(p, self.initial_accumulator_value)
            for n, p in params.items()}}

    def _step(self, b, lr, count):
        ps, gs = b.ps, b.gs
        ss = b.slots["sum_of_squares"]
        torch._foreach_addcmul_(ss, gs, gs)
        inv = torch._foreach_add(ss, self.eps)
        torch._foreach_rsqrt_(inv)
        torch._foreach_mul_(inv, gs)
        self._apply(ps, inv, lr)


class _Adadelta(Optimizer):
    """optax.adadelta: ``e_g`` and ``e_x`` EMAs of the squared gradient and
    update, ``u = sqrt(e_x + eps) / sqrt(e_g + eps) * g`` (its weight
    decay is 0 here, as the JAX package builds it)."""


    def __init__(self, schedule, rho, eps):
        super().__init__(schedule, "adadelta")
        self.rho, self.eps = rho, eps

    def _init(self, params):
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        return {"e_g": zeros(), "e_x": zeros()}

    def _step(self, b, lr, count):
        ps, gs = b.ps, b.gs
        rho = self.rho
        e_g, e_x = b.slots["e_g"], b.slots["e_x"]
        torch._foreach_mul_(e_g, rho)
        torch._foreach_addcmul_(e_g, gs, gs, value=1.0 - rho)
        num = torch._foreach_add(e_x, self.eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, self.eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(num, den)
        torch._foreach_mul_(num, gs)                  # the update
        torch._foreach_mul_(e_x, rho)
        torch._foreach_addcmul_(e_x, num, num, value=1.0 - rho)
        self._apply(ps, num, lr)


class _RMSprop(Optimizer):
    """optax.rmsprop: ``nu`` EMA of the squared gradient from 0,
    ``u = g / sqrt(nu + eps)``."""


    def __init__(self, schedule, decay, eps):
        super().__init__(schedule, "rmsprop")
        self.decay, self.eps = decay, eps

    def _init(self, params):
        return {"nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def _step(self, b, lr, count):
        ps, gs = b.ps, b.gs
        nu = b.slots["nu"]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - self.decay)
        upd = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(upd)
        torch._foreach_mul_(upd, gs)
        self._apply(ps, upd, lr)


class _LARS(Optimizer):
    """optax.lars: ``g + wd * p`` and the trust ratio
    ``coeff * |p| / (|u| + eps)`` on the masked parameters, ``-lr``, then
    momentum (``trace``) on the scaled update."""


    def __init__(self, schedule, momentum, weight_decay, trust_coefficient,
                 eps, nesterov, mask):
        super().__init__(schedule, "lars")
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trust_coefficient = trust_coefficient
        self.eps = eps
        self.nesterov = nesterov
        self.mask = mask

    def _init(self, params):
        mask = self.mask(params) if self.mask is not None else None
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()},
                "decayed": [n for n in params if mask is None or mask[n]]}

    def _step(self, b, lr, count):
        ps, gs = b.ps, b.gs
        idx = b.decayed_idx()
        upd = torch._foreach_mul(gs, 1.0)
        if self.weight_decay:
            torch._foreach_add_([upd[i] for i in idx], [ps[i] for i in idx],
                                alpha=self.weight_decay)
        _trust_scale_(upd, ps, idx, b.groups, self.trust_coefficient,
                      self.eps, b.cross)
        torch._foreach_mul_(upd, -lr)
        trace = b.slots["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, upd)              # u + m * t
        out = (torch._foreach_add(upd, trace, alpha=self.momentum)
               if self.nesterov else trace)
        torch._foreach_add_(ps, out)


def _sched(lr, decay) -> Schedule:
    if callable(lr):
        return lr
    if decay:
        return lambda step: lr / (1.0 + decay * step.to(torch.float32))
    return lambda step: lr


def _poly(init: float, end: float, power: float, steps: int) -> Schedule:
    """optax.polynomial_schedule: ``(init - end) * frac**power + end``,
    ``frac = 1 - clip(count, 0, steps) / steps``, in f32."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1.0 - torch.clamp(count, 0, steps) / steps
        return (init - end) * frac.to(torch.float32) ** power + end
    return schedule


def SGD(lr=0.01, momentum=0.0, decay=0.0, nesterov=False) -> Optimizer:
    return _SGD(_sched(lr, decay), momentum, nesterov)


def Adam(lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8, decay=0.0,
         schedule=None) -> Optimizer:
    return _Adam(schedule or _sched(lr, decay), beta_1, beta_2, epsilon,
                 "adam")


def Adamax(lr=0.002, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
           decay=0.0) -> Optimizer:
    return _Adamax(_sched(lr, decay), beta_1, beta_2, epsilon)


def Adagrad(lr=0.01, epsilon=1e-8, decay=0.0) -> Optimizer:
    return _Adagrad(_sched(lr, decay), epsilon)


def Adadelta(lr=1.0, rho=0.95, epsilon=1e-8, decay=0.0) -> Optimizer:
    return _Adadelta(_sched(lr, decay), rho, epsilon)


def RMSprop(lr=0.001, rho=0.9, epsilon=1e-8, decay=0.0) -> Optimizer:
    return _RMSprop(_sched(lr, decay), rho, epsilon)


def PolyWarmup(base_lr: float, warmup_steps: int, total_steps: int,
               power: float = 1.0, end_lr: float = 0.0,
               warmup_power: float = 1.0) -> Schedule:
    """BERT-style warmup then polynomial decay: optax's
    ``join_schedules([warmup, polynomial], [warmup_steps])`` of a count
    tensor.  ``warmup_power`` > 1 is the MLPerf large-batch polynomial
    warmup ``(step / warmup)**p * base_lr``."""
    if warmup_power == 1.0:
        warm = _poly(0.0, base_lr, 1.0, warmup_steps)
    else:
        def warm(step):
            frac = step.to(torch.float32) / max(warmup_steps, 1)
            return base_lr * frac ** warmup_power
    decay = _poly(base_lr, end_lr, power,
                  max(total_steps - warmup_steps, 1))

    def schedule(step):
        step = torch.as_tensor(step)
        return torch.where(step < warmup_steps, _f32(warm(step), step),
                           _f32(decay(step - warmup_steps), step))
    return schedule


def LarsWarmupPoly(base_lr: float, warmup_steps: int, total_steps: int,
                   end_lr: float = 0.0) -> Schedule:
    """The MLPerf-pods LARS schedule: power-2 warmup into power-2
    decay."""
    return PolyWarmup(base_lr, warmup_steps, total_steps, power=2.0,
                      end_lr=end_lr, warmup_power=2.0)


def default_decay_mask(params: Params) -> Dict[str, bool]:
    """The JAX package's weight-decay exclusion set applied to dotted
    names: a parameter decays unless its path, joined with ``/`` and
    lower-cased, contains ``bias``, ``/b``, ``beta``, ``gamma``,
    ``layernorm`` or ``_ln``.  The test is a substring test, as there, so
    any path with a component after the first that starts with ``b``
    matches ``/b`` and takes no decay: BERT's blocks
    (``bert/bert_classifier_bert_block0/...``) do not decay, its
    embeddings and pooler do.  The port keeps that to stay step for
    step."""
    def decays(name: str) -> bool:
        flat = name.replace(".", "/").lower()
        return not any(t in flat for t in ("bias", "/b", "beta", "gamma",
                                           "layernorm", "_ln"))
    return {n: decays(n) for n in params}


def AdamWeightDecay(lr=0.001, warmup_portion=0.1, total=1000,
                    schedule=None, beta_1=0.9, beta_2=0.999, epsilon=1e-6,
                    weight_decay=0.01, state_dtype=None) -> Optimizer:
    """The BERT optimizer: decoupled weight decay outside
    ``default_decay_mask``'s exclusions, linear warmup over
    ``warmup_portion * total`` steps then linear decay to 0 at ``total``.
    ``state_dtype="bfloat16"`` stores the first moment in bf16 (optax's
    ``mu_dtype``); the second moment stays f32, whose per-step change at
    b2 = 0.999 is below bf16's resolution."""
    s = schedule or PolyWarmup(lr, int(warmup_portion * total), total)
    mu_dtype = None
    if state_dtype is not None:
        if str(state_dtype) not in _DTYPES:
            raise ValueError(f"state_dtype must be one of {sorted(_DTYPES)}, "
                             f"got {state_dtype!r}")
        mu_dtype = _DTYPES[str(state_dtype)]
    return _Adam(s, beta_1, beta_2, epsilon, "adam_weight_decay",
                 weight_decay=weight_decay, decay_mask=default_decay_mask,
                 mu_dtype=mu_dtype)


def LAMB(lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-6,
         weight_decay=0.01, schedule=None, mask=None) -> Optimizer:
    """LAMB: Adam moments, decoupled weight decay on the masked subset
    (``default_decay_mask`` unless ``mask`` is given), then each tensor's
    update scaled by its trust ratio ``|p| / |u|``."""
    s = schedule or _sched(lr, 0.0)
    return _Adam(s, beta_1, beta_2, epsilon, "lamb",
                 weight_decay=weight_decay,
                 decay_mask=mask if mask is not None else default_decay_mask,
                 trust_ratio=True)


def LARS(lr=0.1, momentum=0.9, weight_decay=1e-4,
         trust_coefficient=0.001, epsilon=0.0, nesterov=False,
         schedule=None, mask=None) -> Optimizer:
    """LARS: momentum SGD with the layerwise trust ratio
    ``trust_coefficient * |p| / |g + wd * p|``; the parameters outside
    ``mask`` (default ``default_decay_mask``) take neither the decay nor
    the trust scaling."""
    s = schedule or _sched(lr, 0.0)
    return _LARS(s, momentum, weight_decay, trust_coefficient, epsilon,
                 nesterov, mask if mask is not None else default_decay_mask)


_REGISTRY = {
    "sgd": SGD, "adam": Adam, "adamax": Adamax, "adagrad": Adagrad,
    "adadelta": Adadelta, "rmsprop": RMSprop,
    "adam_weight_decay": AdamWeightDecay, "adamweightdecay": AdamWeightDecay,
    "lamb": LAMB, "lars": LARS,
    # tf.train-style names
    "gradientdescent": SGD, "momentum": lambda lr=0.01: SGD(lr, momentum=0.9),
}


def get(opt: Union[str, Optimizer]) -> Optimizer:
    if isinstance(opt, Optimizer):
        return opt
    try:
        return _REGISTRY[opt.lower()]()
    except (KeyError, AttributeError):
        raise ValueError(f"unknown optimizer: {opt!r}") from None
