"""Keras-style layers, the functional graph and the nets, as nn.Modules.

Port of ``analytics_zoo_tpu/keras/engine.py``.  The JAX package keeps
weights outside its layers (``build(rng, shape) -> (params, state)``,
pure ``call(params, state, x, ...)``); here a layer owns its parameters,
as PyTorch modules do, and lays them out so that its ``state_dict`` names
ARE the JAX trees' paths joined with dots: a layer's child module or
parameter is registered under the key the JAX layer gives it, and a net
registers each layer under the layer's name, as the JAX nets key their
trees by layer name.  What the JAX package keeps in ``state`` (a frozen
embedding table) is a buffer here, which no optimizer sees.
``get_weights`` / ``set_weights`` carry ``(params, state)`` as nested
dicts of numpy arrays (``interop``).

A layer whose weights depend on its input's shape (``Dense``) creates
them when it is first called on a ``Variable`` of the functional graph
(``Input`` / ``Model``), or when ``Sequential`` adds it after a layer of
known shape, or in ``init(input_shape=...)``.  Unnamed layers take the
JAX names (``dense_1``, ``flatten_2``, ...) from a per-process counter
that ``reset_uids`` clears, so the same construction order gives the same
parameter tree.

``KerasNet.compile / fit / evaluate / predict`` run ``estimator.Estimator``
on the device the net's weights are on; a ``Model`` or ``Sequential``
goes to the card when built unless ``device=`` names another.
"""

from __future__ import annotations

import copy
import inspect
import itertools
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.unported import QUEUE_ITEMS

Shape = Tuple[Optional[int], ...]

_uid_counters: Dict[str, int] = {}


def _auto_name(prefix: str) -> str:
    _uid_counters[prefix] = _uid_counters.get(prefix, 0) + 1
    return f"{prefix}_{_uid_counters[prefix]}"


def reset_uids() -> None:
    _uid_counters.clear()


def _symbolic(x) -> bool:
    """True for a ``Variable`` or a list / tuple holding one."""
    if isinstance(x, (list, tuple)):
        return any(isinstance(v, Variable) for v in x)
    return isinstance(x, Variable)


class Layer(nn.Module):
    """Base layer: a named ``nn.Module``.  Subclasses create their
    parameters in ``__init__`` (or, when they need the input's shape, in
    ``build``) and fill them in ``reset_parameters``.  Called on a tensor
    it runs ``forward``; called on a ``Variable`` (or a list of them) it
    adds a node to the functional graph.  A layer starts in eval mode, as
    the JAX layers' ``training`` argument defaults to False."""

    def __init__(self, input_shape: Optional[Shape] = None,
                 name: Optional[str] = None):
        super().__init__()
        self.training = False
        self.name = name or _auto_name(type(self).__name__.lower())
        self.input_shape = ((None,) + tuple(input_shape) if input_shape
                            else None)
        # False for a layer whose weights wait for its input's shape
        self.built = True

    def build(self, input_shape: Shape) -> None:
        """Create the parameters that depend on ``input_shape`` (batch
        entry included)."""

    def ensure_built(self, input_shape: Shape) -> None:
        if not self.built:
            self.build(input_shape)
            self.built = True
            self.reset_parameters()

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        return input_shape

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Fill this layer's own parameters (not its children's)."""

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None,
             input_shape: Optional[Shape] = None) -> "Layer":
        """Build the layer if it still waits for its input's shape
        (``input_shape`` or the one given at construction), then
        (re)initialise every parameter of the tree from ``generator``
        (``torch.Generator`` on the parameters' device, or None for the
        global one)."""
        if not self.built:
            shape = input_shape or self.input_shape
            if shape is None:
                raise ValueError(f"{self.name}: input_shape unknown; pass "
                                 "one")
            self.ensure_built(shape)
        for m in self.modules():
            if isinstance(m, Layer):
                m.reset_parameters(generator)
        return self

    def __call__(self, *args, **kwargs):
        if args and _symbolic(args[0]):
            return Variable._from_layer(self, args[0])
        return super().__call__(*args, **kwargs)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


class Lambda(Layer):
    """A tensor function as a layer; its output shape is traced on
    ``meta`` tensors (no data, no device) unless ``output_shape_fn`` gives
    it."""

    def __init__(self, fn: Callable,
                 output_shape_fn: Optional[Callable] = None, **kw):
        super().__init__(**kw)
        self.fn = fn
        self.output_shape_fn = output_shape_fn

    def forward(self, x):
        return self.fn(x)

    def compute_output_shape(self, input_shape):
        if self.output_shape_fn:
            return self.output_shape_fn(input_shape)

        def probe(shape):
            return torch.zeros((1,) + tuple(s or 1 for s in shape[1:]),
                               device="meta")
        if isinstance(input_shape, list):
            out = self.fn([probe(s) for s in input_shape])
        else:
            out = self.fn(probe(input_shape))
        return (None,) + tuple(out.shape[1:])


def _const(other, x: torch.Tensor):
    """A Python number as is; an array as a tensor beside ``x`` (in
    ``x``'s dtype when both are floating, as JAX promotes a weak f64)."""
    if isinstance(other, (int, float, torch.Tensor)):
        return other
    t = torch.as_tensor(np.asarray(other), device=x.device)
    return t.to(x.dtype) if x.is_floating_point() else t


class Variable:
    """A symbolic tensor of the functional graph: the producing layer and
    its input variables; ``Model`` runs the DAG.  The arithmetic operators
    build ``Lambda`` nodes, as in the JAX package."""

    def __init__(self, shape: Shape, layer: Optional[Layer] = None,
                 inputs: Optional[List["Variable"]] = None,
                 name: Optional[str] = None):
        self.shape = tuple(shape)
        self.layer = layer
        self.inputs = inputs or []
        self.name = name or (layer.name if layer else _auto_name("input"))

    @staticmethod
    def _from_layer(layer: Layer,
                    inputs: Union["Variable", Sequence["Variable"]]
                    ) -> "Variable":
        ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        for v in ins:
            if not isinstance(v, Variable):
                raise TypeError(f"layer {layer.name} called on non-Variable")
        in_shape = ([v.shape for v in ins] if len(ins) > 1 else ins[0].shape)
        layer.ensure_built(in_shape)
        out_shape = layer.compute_output_shape(in_shape)
        return Variable(out_shape, layer=layer, inputs=ins)

    # ---- autograd math surface --------------------------------------------
    def _binop(self, other, fn, opname):
        if isinstance(other, Variable):
            merged = Lambda(lambda xs: fn(xs[0], xs[1]),
                            name=_auto_name(opname))
            return Variable._from_layer(merged, [self, other])
        lam = Lambda(lambda x: fn(x, _const(other, x)),
                     name=_auto_name(opname))
        return Variable._from_layer(lam, self)

    def __add__(self, other):
        return self._binop(other, torch.add, "add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, torch.sub, "sub")

    def __rsub__(self, other):
        return self._binop(other, lambda x, o: o - x, "rsub")

    def __mul__(self, other):
        return self._binop(other, torch.mul, "mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, torch.div, "div")

    def __rtruediv__(self, other):
        return self._binop(other, lambda x, o: o / x, "rdiv")

    def __pow__(self, a):
        return self._binop(a, torch.pow, "pow")

    def __neg__(self):
        return Variable._from_layer(
            Lambda(torch.neg, name=_auto_name("neg")), self)

    # ---- shape surgery ----------------------------------------------------
    def slice(self, dim: int, start_index: int, length: int) -> "Variable":
        """Narrow ``length`` elements from ``start_index`` along ``dim``
        (batch dim included)."""
        idx = [slice(None)] * len(self.shape)
        idx[dim] = slice(start_index, start_index + length)
        return Variable._from_layer(
            Lambda(lambda x: x[tuple(idx)], name=_auto_name("slice")), self)

    def index_select(self, dim: int, index: int) -> "Variable":
        """Select one subtensor along ``dim``."""
        return Variable._from_layer(
            Lambda(lambda x: torch.select(x, dim, index),
                   name=_auto_name("index_select")), self)

    def squeeze(self, dim: Optional[int] = None) -> "Variable":
        return Variable._from_layer(
            Lambda(lambda x: torch.squeeze(x) if dim is None
                   else torch.squeeze(x, dim),
                   name=_auto_name("squeeze")), self)


def Input(shape: Shape, name: Optional[str] = None) -> Variable:
    """Entry node of a functional graph (batch dim excluded, Keras-1 style)."""
    return Variable((None,) + tuple(shape), name=name or _auto_name("input"))


def _seeded(layer: nn.Module) -> bool:
    """Whether ``layer``'s forward takes a dropout ``seed``."""
    return "seed" in inspect.signature(layer.forward).parameters


class KerasNet(Layer):
    """Base of the port's nets: an ``nn.Module`` called as
    ``net(x, seed=None)`` (the seed drives dropout in training mode), with
    its weights readable and writable in the JAX tree layout, and
    ``compile`` / ``fit`` / ``evaluate`` / ``predict`` over
    ``estimator.Estimator`` on the device its weights are on."""

    _device: Optional[torch.device] = None
    _train_summary_dir: Optional[str] = None
    _app_name: Optional[str] = None
    _checkpoint_dir: Optional[str] = None

    def __init__(self, **kw):
        super().__init__(**kw)
        self.optimizer = None
        self.loss = None
        self.metrics: List = []
        self._last_estimator = None

    @property
    def device(self) -> Optional[torch.device]:
        """Where the weights are (the device asked for at construction
        when the net has none)."""
        for t in itertools.chain(self.parameters(), self.buffers()):
            return t.device
        return self._device

    def _register(self, layer: nn.Module) -> None:
        """Hold ``layer`` as the child named by its name (the JAX trees'
        key), once however often the graph calls it."""
        held = self._modules.get(layer.name)
        if held is layer:
            return
        if held is not None:
            raise ValueError(f"two layers are named {layer.name!r}")
        self.add_module(layer.name, layer)

    def get_weights(self) -> Tuple[dict, dict]:
        """``(params, state)`` as nested dicts of numpy arrays in the JAX
        package's tree layout; state holds the buffers (frozen tables)."""
        from analytics_zoo_tpu_torch.interop import params_tree, state_tree
        return params_tree(self), state_tree(self)

    def set_weights(self, variables) -> None:
        """Load ``(params, state)`` or a bare params tree (JAX layout),
        strictly one to one."""
        from analytics_zoo_tpu_torch.interop import load_jax_params
        if isinstance(variables, tuple):
            load_jax_params(self, variables[0], variables[1])
        else:
            load_jax_params(self, variables)

    @torch.inference_mode()
    def predict_fn(self, x):
        """The inference forward: ``forward(x)`` in eval mode, no autograd."""
        if self.training:
            self.eval()
        return self(x)

    # ---- user API ---------------------------------------------------------
    def compile(self, optimizer, loss, metrics: Optional[List] = None):
        from analytics_zoo_tpu_torch.keras import losses as losses_mod
        from analytics_zoo_tpu_torch.keras import metrics as metrics_mod
        from analytics_zoo_tpu_torch.keras import optimizers as optim_mod
        if isinstance(optimizer, dict):
            raise ValueError(
                "per-name optimizer dicts are for multi-optimizer training "
                "(e.g. GANEstimator); compile() takes a single optimizer")
        self.optimizer = optim_mod.get(optimizer)
        self.loss = losses_mod.get(loss)
        self.metrics = [metrics_mod.get(m) for m in (metrics or [])]

    def set_tensorboard(self, log_dir: str, app_name: str) -> None:
        """Write the training curves of later ``fit`` calls under
        ``log_dir/app_name/train``."""
        self._train_summary_dir = log_dir
        self._app_name = app_name

    def set_checkpoint(self, path: str) -> None:
        """Checkpoint later ``fit`` calls into ``path`` (every epoch)."""
        self._checkpoint_dir = path

    def _estimator(self, **kw):
        from analytics_zoo_tpu_torch.estimator import Estimator
        kw.setdefault("device", self.device)
        return Estimator(self, self.optimizer, self.loss, self.metrics, **kw)

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 1,
            validation_data=None, distributed: bool = True,
            seed: Optional[int] = None, warm_start: bool = False,
            **estimator_kw):
        """Train on ``x`` (a FeatureSet, or arrays with ``y``) for
        ``nb_epoch`` epochs; returns the estimator's history.  A cold fit
        starts a new optimizer state from the current weights;
        ``warm_start=True`` continues the last fit's estimator (its
        optimizer state and global step).  ``estimator_kw`` go to
        ``Estimator``, ``device`` included (default: where the weights
        are), and ``shard_optimizer`` / ``grad_accum_steps`` /
        ``shard_model``, which shard the step over the global context's
        mesh.  ``distributed`` is accepted for the JAX surface."""
        from analytics_zoo_tpu_torch.data.featureset import FeatureSet
        if self.optimizer is None:
            raise RuntimeError("call compile() before fit()")
        if not hasattr(x, "batches"):
            x = FeatureSet.from_ndarrays(x, y)
        if validation_data is not None and not hasattr(validation_data,
                                                       "batches"):
            vx, vy = validation_data
            validation_data = FeatureSet.from_ndarrays(vx, vy, shuffle=False)
        est = self._last_estimator if warm_start else None
        if est is None:
            est = self._estimator(
                **{"tensorboard_dir": self._train_summary_dir,
                   "app_name": self._app_name,
                   "checkpoint_dir": self._checkpoint_dir, **estimator_kw})
        elif estimator_kw:
            raise ValueError(
                "estimator kwargs cannot change on a warm-start refit; start "
                f"a cold fit instead: {sorted(estimator_kw)}")
        est.train(x, batch_size=batch_size, epochs=nb_epoch,
                  validation_data=validation_data, seed=seed)
        self._last_estimator = est
        return est.history

    def evaluate(self, x, y=None, batch_size: int = 32) -> Dict[str, float]:
        from analytics_zoo_tpu_torch.data.featureset import FeatureSet
        if self.loss is None and not self.metrics:
            raise RuntimeError("call compile() before evaluate()")
        if not hasattr(x, "batches"):
            x = FeatureSet.from_ndarrays(x, y, shuffle=False)
        return self._estimator().evaluate(x, batch_size=batch_size)

    def predict(self, x, batch_size: int = 32, distributed: bool = True):
        from analytics_zoo_tpu_torch.data.featureset import FeatureSet
        if not hasattr(x, "batches"):
            x = FeatureSet.from_ndarrays(x, shuffle=False)
        return self._estimator().predict(x, batch_size=batch_size)

    # ---- persistence: the JAX file layout --------------------------------
    def save(self, path: str) -> None:
        """Pickle ``{"model", "params", "state"}`` as the JAX package does:
        the net (on the host, without its weights' values mattering: they
        are the numpy trees beside it, in the JAX layout), its parameter
        tree and its state tree.  Only the port reads the file back: the
        JAX package cannot unpickle a PyTorch module, and the port cannot
        unpickle a JAX-written ``"model"`` (ROADMAP Queue 1 item 2)."""
        params, state = self.get_weights()
        # what is compiled or trained stays out of the file, as in the JAX
        # package (its loader compiles anew)
        held = (self.optimizer, self.loss, self.metrics,
                self._last_estimator)
        self.optimizer, self.loss, self.metrics = None, None, []
        self._last_estimator = None
        try:
            net = copy.deepcopy(self).to("cpu")
        finally:
            (self.optimizer, self.loss, self.metrics,
             self._last_estimator) = held
        net._device = None
        with open(path, "wb") as fh:
            pickle.dump({"model": net, "params": params, "state": state}, fh)

    @staticmethod
    def load(path: str, device=None) -> "KerasNet":
        """The net of a file ``save`` wrote, with its weights, on
        ``device`` (default: the card).  A file the JAX package wrote
        holds a JAX net, which the port cannot load: that raises."""
        with open(path, "rb") as fh:
            blob = _PortUnpickler(fh).load()
        net = blob["model"]
        net.set_weights((blob["params"], blob["state"]))
        _place(net, device)
        return net


class _PortUnpickler(pickle.Unpickler):
    """Refuses the JAX package's classes with a message that says why."""

    def find_class(self, module, name):
        if module.split(".")[0] in ("analytics_zoo_tpu", "jax", "jaxlib"):
            raise NotImplementedError(
                f"this file holds a JAX net ({module}.{name}); loading a "
                f"JAX-written KerasNet is not ported ({QUEUE_ITEMS[2]}); "
                f"load its weights with interop.load_jax_params instead")
        return super().find_class(module, name)


def _place(net: KerasNet, device) -> None:
    from analytics_zoo_tpu_torch.common.context import resolve_device
    net._device = resolve_device(device)
    net.to(net._device)


class Sequential(KerasNet):
    """Linear stack; the first layer carries ``input_shape`` (Keras-1
    rule), or ``init(input_shape=...)`` gives it."""

    def __init__(self, layers: Optional[List[Layer]] = None,
                 device=None, **kw):
        super().__init__(**kw)
        _place(self, device)
        self.layers: List[Layer] = []
        self.built = False
        for layer in layers or []:
            self.add(layer)

    def add(self, layer: Layer) -> "Sequential":
        if not self.layers and self.input_shape is None:
            self.input_shape = layer.input_shape
        # a layer built at construction holds its weights on the host:
        # they join the net's device before they count in ``device``
        layer.to(self.device)
        self._register(layer)
        self.layers.append(layer)
        if self.input_shape is not None:
            self.build(self.input_shape)
            self.built = True
        return self

    def build(self, input_shape: Shape) -> None:
        """Build the layers still waiting for their input's shape, on the
        net's device (read before the new weights exist)."""
        device = self.device
        s = input_shape
        for layer in self.layers:
            layer.ensure_built(s)
            s = layer.compute_output_shape(s)
        self.to(device)

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        s = input_shape
        for layer in self.layers:
            s = layer.compute_output_shape(s)
        return s

    def forward(self, x, seed: Optional[int] = None):
        from analytics_zoo_tpu_torch.ops.dropout import derive_seed
        if not self.built:
            raise RuntimeError(f"{self.name}: input_shape unknown; call "
                               "init(input_shape=...) first")
        for i, layer in enumerate(self.layers):
            kw = ({"seed": derive_seed(seed, i)}
                  if seed is not None and _seeded(layer) else {})
            x = layer(x, **kw)
        return x


class Model(KerasNet):
    """Functional graph model over the ``Variable`` DAG, in the JAX
    package's topological order.  ``forward`` takes the inputs as a list,
    a tuple, a single tensor, or a dict keyed by input name (what the
    serving engine sends)."""

    def __init__(self, input: Union[Variable, List[Variable]],
                 output: Union[Variable, List[Variable]], device=None,
                 **kw):
        super().__init__(**kw)
        self.inputs = input if isinstance(input, list) else [input]
        self.outputs = output if isinstance(output, list) else [output]
        self._topo = self._toposort()
        self.input_shape = ([v.shape for v in self.inputs]
                            if len(self.inputs) > 1 else self.inputs[0].shape)
        for v in self._topo:
            if v.layer is not None:
                self._register(v.layer)
        self._seeded = [v.layer is not None and _seeded(v.layer)
                        for v in self._topo]
        _place(self, device)

    def _toposort(self) -> List[Variable]:
        seen, order = set(), []

        def visit(v: Variable):
            if id(v) in seen:
                return
            seen.add(id(v))
            for u in v.inputs:
                visit(u)
            order.append(v)

        for out in self.outputs:
            visit(out)
        return order

    @property
    def layers(self) -> List[Layer]:
        return [v.layer for v in self._topo if v.layer is not None]

    def compute_output_shape(self, input_shape):
        shapes = [v.shape for v in self.outputs]
        return shapes[0] if len(shapes) == 1 else shapes

    def forward(self, x, seed: Optional[int] = None):
        from analytics_zoo_tpu_torch.ops.dropout import derive_seed
        if isinstance(x, dict):
            xs = [x[v.name] for v in self.inputs]
        else:
            xs = list(x) if isinstance(x, (list, tuple)) else [x]
        if len(xs) != len(self.inputs):
            raise ValueError(
                f"model expects {len(self.inputs)} inputs, got {len(xs)}")
        values = {id(v): xv for v, xv in zip(self.inputs, xs)}
        for i, v in enumerate(self._topo):
            if v.layer is None:
                if id(v) not in values:
                    raise ValueError(f"unbound input variable {v.name}")
                continue
            ins = [values[id(u)] for u in v.inputs]
            arg = None if not ins else (ins if len(ins) > 1 else ins[0])
            kw = ({"seed": derive_seed(seed, i)}
                  if seed is not None and self._seeded[i] else {})
            values[id(v)] = v.layer(arg, **kw)
        outs = [values[id(o)] for o in self.outputs]
        return outs[0] if len(outs) == 1 else outs
