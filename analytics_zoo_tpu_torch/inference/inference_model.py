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

``place`` / ``unplace`` (the multi-model weight cache) and the TF, ONNX
and Caffe loaders are not ported yet.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.context import resolve_device
from analytics_zoo_tpu_torch.common.unported import reject

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
        # weights always go to the device on load: keeping them on the host
        # until placed is the multi-model weight cache's
        reject("InferenceModel", 1, dict(place_on_load=True),
               place_on_load=place_on_load)
        self.device = resolve_device(device)
        self.concurrency = supported_concurrent_num
        self.model = None
        self.preprocessor = None
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
        """Serve ``model``, moved to this model's device in place.
        ``variables`` is ``(params, state)`` or a bare params tree in the
        JAX layout; None keeps the model's current weights.
        ``preprocessor`` maps the request (arrays already on the device,
        in the request's dict / list structure) to the model's input, e.g.
        ``lambda d: [d["input_ids"], d["token_type_ids"],
        d["input_mask"]]`` for BERT.  ``place`` None or True (the
        default placement): ``place=False`` raises, as the constructor's
        ``place_on_load=False`` does."""
        reject("InferenceModel.load_keras", 1, dict(place=True),
               place=True if place is None else place)
        model.to(self.device)
        if variables is not None:
            model.set_weights(variables)
        model.eval()
        self.model = model
        self.preprocessor = preprocessor
        return self

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

    def predict_async(self, x, pad_to_bucket: bool = True,
                      reserved: bool = False):
        """Launch without waiting for the device; returns a handle for
        ``fetch``.  The slot is held only across the launch, and at most
        2x ``supported_concurrent_num`` handles are outstanding (blocks
        here beyond that).  ``reserved=True`` (a multi-model engine's
        reserved slot) is not ported yet and raises."""
        reject("InferenceModel.predict_async", 1, reserved=reserved or None)
        if self.model is None:
            raise RuntimeError("no model loaded")
        x = _tree_map(np.asarray, x)
        n = example_x_shape0(x)
        m = _next_pow2(n) if pad_to_bucket else n
        if m != n:
            x = _resize_batch(x, m)
        self._inflight.acquire()
        try:
            slot = self._slots.get()
            try:
                y = self._forward(x)
                done = None
                if self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
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
