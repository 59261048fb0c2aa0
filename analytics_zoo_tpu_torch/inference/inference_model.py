"""InferenceModel: concurrent prediction over one loaded model.

Port of ``analytics_zoo_tpu/inference/inference_model.py``: one set of
weights on the device, a queue of N execution slots (the reference's model
queue), a bound of 2N dispatched-but-unfetched batches, and batches padded
with zero rows up to the next power of two so that a serving loop sees
few distinct shapes.  PyTorch runs eagerly, so there is no per-shape
program cache; ``warmup`` runs each bucket once so that kernel builds and
library handles are paid before the first request.

Threads: ``predict_async`` may be called from several threads at once
(the pipelined ``ClusterServing`` dispatches from a pool of them) and
``fetch`` from another (its sink).  A dispatch launches on the calling
thread's current stream of the device and records a CUDA event there;
``fetch`` makes its own current stream wait on that event before the
copy to the host, so a result is never read before the work that wrote
it, whichever streams the two threads use.

Weight residency (the multi-model weight cache, ``serving/model_zoo.py``):
``place_on_load=False`` / ``load_keras(place=False)`` keep the weights in
pinned host tensors, so a model registered cold holds no card memory.
``place()`` copies them into fresh device tensors on the calling thread's
current stream (the registry's pager runs it on a stream of its own) and
synchronises that stream before it returns, so a failed transfer surfaces
there, never at a request's dispatch.  ``unplace()`` first waits for the
last dispatch on each stream that read the weights, then drops every
reference to the device tensors, so ``torch.cuda.memory_allocated()``
falls by ``weight_nbytes`` at once and the caching allocator never hands
their blocks out while a dispatch may still read them.  The module keeps
its parameter and buffer objects throughout: only their data moves.
``reserve`` / ``predict_async(reserved=True)`` take the in-flight permit
in the caller's thread, as the JAX model does.

The TF, ONNX and Caffe loaders are not ported yet.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.testing import chaos

logger = logging.getLogger("analytics_zoo_tpu_torch.inference")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _tree_map(fn, x):
    """Map ``fn`` over the arrays of a dict / list / tuple tree."""
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _leaves(x):
    if isinstance(x, dict):
        return [l for v in x.values() for l in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [l for v in x for l in _leaves(v)]
    return [x]


def example_x_shape0(x) -> int:
    return _leaves(x)[0].shape[0]


def _resize_batch(x, m: int):
    def fix(a):
        n = a.shape[0]
        if n == m:
            return a
        if n > m:
            return a[:m]
        pad = np.zeros((m - n,) + a.shape[1:], a.dtype)
        return np.concatenate([a, pad])
    return _tree_map(fix, x)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    # wire frames decode to read-only views, which torch will not wrap
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()   # numpy has no bfloat16
    return t.cpu().numpy()


class InferenceModel:
    """Concurrent predictor over a port model (a ``KerasNet``).

    ``supported_concurrent_num`` is the number of callers allowed in the
    device section at once, as in the reference constructor.  ``device``
    defaults to the card and raises when there is none.
    """

    def __init__(self, supported_concurrent_num: int = 1,
                 place_on_load: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.concurrency = supported_concurrent_num
        # False: every load stages to host memory only, until place()
        self.place_on_load = place_on_load
        self.model = None
        self.preprocessor = None
        self._placed = False
        # name -> host copy of each parameter and buffer (pinned on the
        # card's host), or None while only the device copy exists
        self._host: Optional[Dict[str, torch.Tensor]] = None
        # the last dispatch's event on each stream that read the weights
        self._last_done: Dict[int, torch.cuda.Event] = {}
        self._done_lock = threading.Lock()
        self._slots: "queue.Queue[int]" = queue.Queue()
        for i in range(supported_concurrent_num):
            self._slots.put(i)
        # bounds dispatched-but-unfetched batches (device buffers in
        # flight), released by fetch()
        self._inflight = threading.BoundedSemaphore(
            2 * supported_concurrent_num)

    def load_keras(self, model, variables: Optional[Tuple] = None,
                   preprocessor=None,
                   place: Optional[bool] = None) -> "InferenceModel":
        """Serve ``model``.  ``variables`` is ``(params, state)`` or a bare
        params tree in the JAX layout; None keeps the model's current
        weights.  ``preprocessor`` maps the request (arrays already on the
        device, in the request's dict / list structure) to the model's
        input, e.g. ``lambda d: [d["input_ids"], d["token_type_ids"],
        d["input_mask"]]`` for BERT.  ``place`` (default: the
        constructor's ``place_on_load``) moves the model to this model's
        device now; ``place=False`` stages its weights in host memory
        only (pinned when the device is the card), to be placed by
        ``place()`` or the registry's pager."""
        if variables is not None:
            model.set_weights(variables)
        model.eval()
        self.model = model
        self.preprocessor = preprocessor
        self._host = None
        if self.place_on_load if place is None else place:
            model.to(self.device)
            self._placed = True
        else:
            self._placed = True         # wherever the weights are now
            self.stage_host()
            self._assign(self._host)
            self._placed = False
        return self

    # ---- weight residency (the multi-model weight cache) ------------------
    def _weight_slots(self):
        """(module, kind, attribute name, qualified name) of every
        parameter and buffer."""
        out = []
        for mname, mod in self.model.named_modules():
            for kind, table in (("p", mod._parameters),
                                ("b", mod._buffers)):
                for n, t in table.items():
                    if t is not None:
                        out.append((mod, kind, n,
                                    f"{mname}.{n}" if mname else n))
        return out

    def _tensors(self) -> Dict[str, torch.Tensor]:
        return {q: (mod._parameters if kind == "p" else mod._buffers)[n]
                for mod, kind, n, q in self._weight_slots()}

    def _assign(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Point every parameter (its ``.data``) and buffer at
        ``tensors``: the module's objects stay, their storage moves."""
        with torch.no_grad():
            for mod, kind, n, q in self._weight_slots():
                if kind == "p":
                    mod._parameters[n].data = tensors[q]
                else:
                    mod._buffers[n] = tensors[q]

    def stage_host(self) -> "InferenceModel":
        """Capture the host copy now (a read of the placed weights), so a
        later ``unplace()`` only releases memory.  The registry calls this
        at registration for an evictable model: eviction runs under its
        lock, where a device-to-host read would stall every model."""
        if self._placed and self._host is None:
            pin = self.device.type == "cuda"
            host = {}
            for q, t in self._tensors().items():
                h = t.detach().to("cpu", copy=True)
                host[q] = h.pin_memory() if pin else h
            self._host = host
        return self

    def place(self) -> "InferenceModel":
        """Copy the host-staged weights into fresh tensors on this model's
        device, on the calling thread's current stream, and wait for that
        stream before returning.  Idempotent."""
        if self._placed:
            return self
        if self._host is None:
            raise RuntimeError("no weights loaded; load_keras() first")
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            dev = {q: h.to(self.device, non_blocking=True)
                   for q, h in self._host.items()}
            stream.synchronize()
        else:
            dev = {q: h.clone() for q, h in self._host.items()}
        self._assign(dev)
        self._placed = True
        return self

    def unplace(self) -> "InferenceModel":
        """Release the device copy of the weights now, back to the host
        copy (captured first if the model was placed at load)."""
        if not self._placed:
            return self
        self.stage_host()
        with self._done_lock:
            done, self._last_done = list(self._last_done.values()), {}
        for ev in done:
            # the dispatches that read these tensors have finished before
            # their blocks go back to the allocator
            ev.synchronize()
        self._assign(self._host)
        self._placed = False
        return self

    @property
    def placed(self) -> bool:
        return self._placed

    @property
    def weight_nbytes(self) -> int:
        """Bytes of the weights (parameters and buffers), host- or
        device-resident: what the weight cache books on a page-in."""
        return int(sum(t.numel() * t.element_size()
                       for t in self._tensors().values())) \
            if self.model is not None else 0

    @property
    def weight_blocks(self) -> int:
        """Weight tensors placed on the device: the unit of the weight
        cache's block books."""
        return len(self._weight_slots()) if self.model is not None else 0

    def _forward(self, x):
        with torch.inference_mode():
            xt = _tree_map(lambda a: _to_tensor(a).to(self.device), x)
            if self.preprocessor is not None:
                xt = self.preprocessor(xt)
            return self.model.predict_fn(xt)

    def warmup(self, example_x, batch_sizes: Sequence[int] = ()) -> None:
        """Run each power-of-two bucket the sizes fall in once, so the
        first request pays no kernel build or library set-up."""
        for b in (batch_sizes or [example_x_shape0(example_x)]):
            self.predict(_resize_batch(
                _tree_map(np.asarray, example_x), _next_pow2(b)))

    def predict(self, x, pad_to_bucket: bool = True):
        """Thread-safe prediction; blocks for an execution slot like the
        reference's model-queue ``doPredict``."""
        return self.fetch(self.predict_async(x, pad_to_bucket))

    def reserve(self) -> None:
        """Take an in-flight permit in the caller's thread; pass
        ``reserved=True`` to the matching ``predict_async``.  A pipelined
        caller that dispatches from a pool but consumes results in
        submission order takes permits in its one submitting thread, so
        permit order is submission order."""
        self._inflight.acquire()

    def release_reservation(self) -> None:
        """Return a ``reserve()`` permit whose dispatch never happened."""
        self._inflight.release()

    def predict_async(self, x, pad_to_bucket: bool = True,
                      reserved: bool = False):
        """Launch without waiting for the device; returns a handle for
        ``fetch``.  The slot is held only across the launch, and at most
        2x ``supported_concurrent_num`` handles are outstanding (blocks
        here beyond that, unless ``reserved``: the permit was taken by
        ``reserve()`` and is released here if the dispatch fails).  The
        ``device_execute`` chaos point fires here on the host, once per
        call, before anything is launched."""
        try:
            if self.model is None:
                raise RuntimeError("no model loaded")
            if not self._placed and self._host is not None:
                raise RuntimeError(
                    "model weights are host-staged; page them in via the "
                    "ModelRegistry (or call place()) before predict")
            chaos.fire("device_execute")
            x = _tree_map(np.asarray, x)
            n = example_x_shape0(x)
            m = _next_pow2(n) if pad_to_bucket else n
            if m != n:
                x = _resize_batch(x, m)
        except BaseException:
            if reserved:           # a reserved permit must not leak
                self._inflight.release()
            raise
        if not reserved:
            self._inflight.acquire()
        try:
            slot = self._slots.get()
            try:
                y = self._forward(x)
                done = None
                if self.device.type == "cuda":
                    stream = torch.cuda.current_stream(self.device)
                    done = torch.cuda.Event()
                    done.record(stream)
                    with self._done_lock:
                        self._last_done[stream.cuda_stream] = done
            finally:
                self._slots.put(slot)
        except BaseException:
            self._inflight.release()
            raise
        return _PendingResult(y, n, self._inflight, done)

    @staticmethod
    def fetch(pending):
        """Copy a ``predict_async`` result to the host (the device sync
        happens here), trimmed to the caller's rows, and release its
        in-flight permit."""
        try:
            if pending.done is not None:
                torch.cuda.current_stream(pending.done.device).wait_event(
                    pending.done)
            return _tree_map(lambda t: _to_numpy(t[:pending.n]), pending.y)
        finally:
            pending.release()


class _PendingResult:
    """``predict_async`` handle; its in-flight permit is released exactly
    once: on ``fetch``, on ``release``, or when an abandoned handle is
    collected."""

    __slots__ = ("y", "n", "done", "_inflight", "_released", "_rel_lock")

    def __init__(self, y, n, inflight, done=None):
        self.y = y
        self.n = n
        # the CUDA event recorded after the dispatch's launches (None on
        # the CPU)
        self.done = done
        self._inflight = inflight
        self._released = False
        self._rel_lock = threading.Lock()

    def release(self) -> None:
        with self._rel_lock:
            if self._released:
                return
            self._released = True
        self._inflight.release()

    def __del__(self):
        try:
            self.release()
        except Exception:  # interpreter teardown
            pass
