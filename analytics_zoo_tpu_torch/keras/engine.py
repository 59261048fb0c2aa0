"""Keras-style layer and model base on ``torch.nn.Module``.

Port of the part of ``analytics_zoo_tpu/keras/engine.py`` the BERT serving
and training slices use.  The JAX package keeps weights outside its layers
(``build(rng, shape) -> params``, pure ``call(params, state, x, ...)``);
here a layer owns its parameters, as PyTorch modules do, and lays them
out so that its ``state_dict`` names ARE the JAX parameter tree's paths
joined with dots: a layer's child module or parameter is registered under
the key the JAX layer gives it.  ``get_weights`` / ``set_weights`` carry
that tree as nested dicts of numpy arrays, which is what
``interop.load_jax_params`` reads.

Training goes through ``estimator.Estimator`` (``tfpark`` estimators);
``compile`` / ``fit`` / ``evaluate`` on the net and the functional
``Variable`` graph are not ported yet (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

_uid_counters: Dict[str, int] = {}


def _auto_name(prefix: str) -> str:
    _uid_counters[prefix] = _uid_counters.get(prefix, 0) + 1
    return f"{prefix}_{_uid_counters[prefix]}"


class Layer(nn.Module):
    """Base layer: a named ``nn.Module``.  Subclasses create their
    parameters in ``__init__`` and fill them in ``reset_parameters``.
    A layer starts in eval mode, as the JAX layers' ``training`` argument
    defaults to False."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.training = False
        self.name = name or _auto_name(type(self).__name__.lower())

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Fill this layer's own parameters (not its children's)."""

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> "Layer":
        """(Re)initialise every parameter of the tree from ``generator``
        (``torch.Generator`` on the parameters' device, or None for the
        global one)."""
        for m in self.modules():
            if isinstance(m, Layer):
                m.reset_parameters(generator)
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


class KerasNet(Layer):
    """Base of the port's models: an ``nn.Module`` called as
    ``net(x, seed=None)`` (the seed drives dropout in training mode), with
    its weights readable and writable in the JAX tree layout."""

    def get_weights(self) -> Tuple[dict, dict]:
        """``(params, state)`` as nested dicts of numpy arrays in the JAX
        package's tree layout (state is empty for the BERT slice)."""
        from analytics_zoo_tpu_torch.interop import params_tree
        return params_tree(self), {}

    def set_weights(self, variables) -> None:
        """Load ``(params, state)`` or a bare params tree (JAX layout)."""
        from analytics_zoo_tpu_torch.interop import load_jax_params
        params = variables[0] if isinstance(variables, tuple) else variables
        load_jax_params(self, params)

    @torch.inference_mode()
    def predict_fn(self, x):
        """The inference forward: ``forward(x)`` in eval mode, no autograd."""
        if self.training:
            self.eval()
        return self(x)
