"""Optimizers, step for step the optax updates of the JAX package.

Port of ``analytics_zoo_tpu/keras/optimizers.py`` (SGD, Adam,
AdamWeightDecay, ``PolyWarmup``, ``default_decay_mask``).  The JAX package
builds them from optax; here each is written out as plain tensor ops
(``torch._foreach_*``, a few multi-tensor launches per step on the card)
that equal optax's step: the schedule is read at the count before the
step, Adam's moments are bias-corrected, ``eps`` sits outside the square
root, and AdamWeightDecay adds the decoupled decay on the masked
parameters, ``p - lr * (u + wd * p)``.

As in optax the optimizer holds no state: ``init(params)`` returns it and
``update(params, grads, state)`` advances it and the parameters in place.
Parameters are a ``{dotted name: tensor}`` dict (``named_parameters``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
_ROADMAP = "not ported yet (ROADMAP Queue 1 item 2: training)"


class Optimizer:
    """An update rule with its learning-rate schedule."""

    def __init__(self, schedule: Callable[[int], float],
                 name: str = "optimizer"):
        self.schedule = schedule
        self.name = name

    def learning_rate(self, step: int) -> float:
        return float(self.schedule(step))

    def init(self, params: Params) -> dict:
        return {"count": 0, **self._init(params)}

    @torch.no_grad()
    def update(self, params: Params, grads: Params, state: dict) -> None:
        """One step: ``params`` and ``state`` change in place."""
        names = list(params)
        lr = self.learning_rate(state["count"])
        state["count"] += 1
        self._step(names, [params[n] for n in names],
                   [grads[n] for n in names], state, lr)

    def _init(self, params: Params) -> dict:
        raise NotImplementedError

    def _step(self, names, ps, gs, state, lr) -> None:
        raise NotImplementedError


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

    def _step(self, names, ps, gs, state, lr):
        upd = gs
        if self.momentum:
            trace = [state["trace"][n] for n in names]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, gs)           # g + m * t
            upd = trace
            if self.nesterov:
                upd = torch._foreach_add(gs, trace, alpha=self.momentum)
        torch._foreach_add_(ps, upd, alpha=-lr)


class _Adam(Optimizer):
    """optax.adam / optax.adamw: bias-corrected moments,
    ``u = mu_hat / (sqrt(nu_hat) + eps)``, plus ``wd * p`` on the
    parameters ``decay_mask`` selects, then ``-lr``."""

    def __init__(self, schedule, b1, b2, eps, name, weight_decay=0.0,
                 decay_mask: Optional[Callable[[Params], Dict[str, bool]]]
                 = None):
        super().__init__(schedule, name)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay_mask = decay_mask

    def _init(self, params):
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        decayed = []
        if self.weight_decay:
            mask = (self.decay_mask(params) if self.decay_mask is not None
                    else dict.fromkeys(params, True))
            decayed = [n for n in params if mask[n]]
        return {"mu": zeros(), "nu": zeros(), "decayed": decayed}

    def _step(self, names, ps, gs, state, lr):
        b1, b2 = self.b1, self.b2
        c = state["count"]                          # after the increment
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - b2)
        # optax's bias corrections are f32, the betas rounded to f32: at
        # b2 = 0.999 that rounding alone moves 1 - b2**c by ~1e-5 relative
        den = torch._foreach_div(nu, 1.0 - float(np.float32(b2)) ** c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, 1.0 - float(np.float32(b1)) ** c)
        torch._foreach_div_(upd, den)
        if state["decayed"]:
            decayed = set(state["decayed"])
            idx = [i for i, n in enumerate(names) if n in decayed]
            torch._foreach_add_([upd[i] for i in idx], [ps[i] for i in idx],
                                alpha=self.weight_decay)
        torch._foreach_add_(ps, upd, alpha=-lr)


def _sched(lr, decay):
    if callable(lr):
        return lr
    if decay:
        return lambda step: lr / (1.0 + decay * step)
    return lambda step: lr


def _poly(init: float, end: float, power: float, steps: int,
          count: int) -> float:
    """optax.polynomial_schedule at ``count``."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac ** power + end


def SGD(lr=0.01, momentum=0.0, decay=0.0, nesterov=False) -> Optimizer:
    return _SGD(_sched(lr, decay), momentum, nesterov)


def Adam(lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8, decay=0.0,
         schedule=None) -> Optimizer:
    return _Adam(schedule or _sched(lr, decay), beta_1, beta_2, epsilon,
                 "adam")


def PolyWarmup(base_lr: float, warmup_steps: int, total_steps: int,
               power: float = 1.0, end_lr: float = 0.0,
               warmup_power: float = 1.0) -> Callable[[int], float]:
    """BERT-style warmup then polynomial decay: optax's
    ``join_schedules([warmup, polynomial], [warmup_steps])``."""
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            if warmup_power == 1.0:
                return _poly(0.0, base_lr, 1.0, warmup_steps, step)
            return base_lr * (step / max(warmup_steps, 1)) ** warmup_power
        return _poly(base_lr, end_lr, power, decay_steps,
                     step - warmup_steps)
    return schedule


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
    Moments are kept in f32; a low-precision ``state_dtype`` is not ported
    yet."""
    if state_dtype is not None:
        raise NotImplementedError(f"AdamWeightDecay(state_dtype=...) is "
                                  f"{_ROADMAP}")
    s = schedule or PolyWarmup(lr, int(warmup_portion * total), total)
    return _Adam(s, beta_1, beta_2, epsilon, "adam_weight_decay",
                 weight_decay=weight_decay, decay_mask=default_decay_mask)


def LAMB(*args, **kwargs):
    raise NotImplementedError(f"LAMB is {_ROADMAP}")


def LARS(*args, **kwargs):
    raise NotImplementedError(f"LARS is {_ROADMAP}")


_REGISTRY = {
    "sgd": SGD, "adam": Adam,
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
