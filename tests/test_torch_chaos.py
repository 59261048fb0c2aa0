"""The port's ``testing/chaos.py`` against the JAX package's, and its
injection points on the port's paths, on the CPU.

The same plan fires at the same invocation indices in both packages, with
the same fault classes, journal events and flight-recorder dumps.  Then
each point the port places fires where the JAX package fires it, and a
fault there fails exactly the work it hit:

- ``device_execute``: once per ``InferenceModel.predict_async``, on the
  host before any launch; the in-flight permits stay balanced;
- ``broker_read``, ``decode``, ``dispatch_submit``, ``device_execute`` in
  the pipelined ``ClusterServing``: the faulted batch gets an error
  result, the next request is served, and the dump's active span is the
  faulted ``serving.dispatch`` with its ``chaos.raise`` event;
- ``decode_step``, ``prefix_match``, ``prefill_chunk`` in ``LLMServing``
  (``DecoderLM.tiny``): the faulted step's sequences finish with
  ``error``, the KV books balance and the next request is served;
- ``checkpoint_write``: the estimator retries from the latest checkpoint
  and ends on the weights of a run without the fault.

Every recorder writes to a ``tmp_path``; every engine stops in a
``finally``; every wait is bounded.
"""

import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.testing import chaos as jchaos
from analytics_zoo_tpu_torch import observability as tobs
from analytics_zoo_tpu_torch.common.config import (
    LLMServingConfig, ServingConfig)
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.llm import GenerationClient, LLMServing
from analytics_zoo_tpu_torch.models.generation import DecoderLM
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import (
    InputQueue, OutputQueue, ServingError)
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.testing import chaos as tchaos

WAIT = 5.0


@pytest.fixture(autouse=True)
def recorders(tmp_path):
    """Each package's recorder in a directory of its own, fresh tracers."""
    recs = (jobs.configure_flight_recorder(dir=str(tmp_path / "jax")),
            tobs.configure_flight_recorder(dir=str(tmp_path / "torch")))
    for O in (jobs, tobs):
        O.get_tracer().clear()
    yield recs
    for O in (jobs, tobs):
        O.configure_flight_recorder()
    jchaos.uninstall()
    tchaos.uninstall()


def test_points_and_faults_are_the_jax_ones():
    assert tchaos.POINTS == jchaos.POINTS and len(tchaos.POINTS) == 21
    assert tchaos.FAULTS == jchaos.FAULTS
    for C in (jchaos, tchaos):
        inj = C.ChaosInjector()
        with pytest.raises(ValueError, match="unknown injection point"):
            inj.plan("nowhere")
        with pytest.raises(ValueError, match="unknown fault"):
            inj.plan("decode", fault="explode")
    assert issubclass(tchaos.ChaosError, RuntimeError)


PLANS = {
    "at": [dict(at=[0, 2, 5])],
    "times": [dict(times=2)],
    "every": [dict(times=None)],
    "first_plan_wins": [dict(at=[1, 3]), dict(at=[3, 4], fault="cancel")],
    "cancel_then_raise": [dict(fault="cancel", times=1),
                          dict(at=[2])],
}


def _fire_six(C, plans):
    inj = C.ChaosInjector()
    for p in plans:
        inj.plan("decode", **p)
    hits = []
    with C.installed(inj):
        for i in range(6):
            try:
                C.fire("decode")
            except C.ChaosError:
                hits.append((i, "raise"))
            except CancelledError:
                hits.append((i, "cancel"))
            C.fire("broker_read")          # no plan: never fires
    C.fire("decode")                       # uninstalled: a no-op
    return hits, inj.count("decode"), inj.injected("decode"), \
        inj.count("broker_read")


@pytest.mark.parametrize("name", list(PLANS))
def test_a_plan_fires_at_the_same_indices(name, recorders):
    got = [_fire_six(C, PLANS[name]) for C in (jchaos, tchaos)]
    assert got[0] == got[1]
    assert got[1][1] == 6 and got[1][3] == 6
    # each fault journals chaos.<fault> and dumps (rate-limited per
    # point:fault): the same kinds, reasons and details in both
    kinds = [[e["kind"] for e in O.get_tracer().export_events()]
             for O in (jobs, tobs)]
    assert kinds[0] == kinds[1] == [f"chaos.{f}" for _, f in got[1][0]]
    dumps = [[(d["reason"], r.read_dump(d["file"])["detail"])
              for d in r.list_dumps()] for r in recorders]
    assert dumps[0] == dumps[1] and dumps[1]


def test_delay_sleeps_and_returns():
    inj = tchaos.ChaosInjector().plan("decode", fault="delay",
                                      delay_s=0.05)
    with tchaos.installed(inj):
        t0 = time.monotonic()
        tchaos.fire("decode")
        assert time.monotonic() - t0 >= 0.05
        tchaos.fire("decode")                  # times=1: spent
    assert inj.injected("decode") == 1 and inj.count("decode") == 2


class _Net(torch.nn.Module):
    """``x @ W`` over any leading shape (a model with no kernel)."""

    def __init__(self, d=4, k=3):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(d, k, generator=g))

    def forward(self, x, seed=None):
        return x @ self.w

    def predict_fn(self, x):
        return self.forward(x)


def test_device_execute_fires_once_per_predict_async_before_any_launch():
    im = InferenceModel(supported_concurrent_num=1,
                        device="cpu").load_keras(_Net())
    x = np.ones((2, 4), np.float32)
    inj = tchaos.ChaosInjector().plan("device_execute", at=[1])
    with tchaos.installed(inj):
        im.predict(x)
        with pytest.raises(tchaos.ChaosError):
            im.predict(x)
        # no permit leaked: more calls than the in-flight bound still run
        for _ in range(4):
            im.predict(x)
    assert inj.count("device_execute") == 6
    assert inj.injected("device_execute") == 1


def _serve(point, fault_at=0, **cfg):
    """One faulted request, then one served, through the pipelined engine:
    returns the outcome of each and the injector."""
    cfg.setdefault("redis_url", "memory://")
    im = InferenceModel(device="cpu").load_keras(_Net())
    broker = InMemoryBroker()
    serving = ClusterServing(im, ServingConfig(**cfg), broker=broker)
    inj = tchaos.ChaosInjector().plan(point, at=[fault_at])
    iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
    outcomes = []
    with tchaos.installed(inj):
        serving.start()
        try:
            for uri in ("faulted", "after"):
                iq.enqueue(uri, x=np.ones(4, np.float32))
                try:
                    r = oq.query_blocking(uri, timeout=WAIT)
                    outcomes.append("ok" if r is not None else "timeout")
                except ServingError:
                    outcomes.append("error")
        finally:
            serving.stop()
    return outcomes, inj


@pytest.mark.parametrize("point", ["dispatch_submit", "device_execute",
                                   "decode"])
def test_a_fault_in_the_pipelined_engine_fails_its_batch_only(
        point, recorders):
    outcomes, inj = _serve(point)
    assert outcomes == ["error", "ok"]
    assert inj.injected(point) == 1
    dumps = recorders[1].list_dumps()
    assert [d["reason"] for d in dumps] == ["chaos"]
    d = recorders[1].read_dump(dumps[0]["file"])
    assert d["detail"] == f"{point}:raise"
    if point != "decode":
        # the dispatch runs inside its serving.dispatch span: the fault
        # lands on it, as the JAX engine's dispatch_submit fault does
        sp = d["active_span"]
        assert sp["name"] == "serving.dispatch"
        assert [e[1] for e in sp["events"]] == ["chaos.raise"]
    else:
        assert d["active_span"]["name"] == "serving.decode"


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipelined", "classic"])
def test_a_broker_read_fault_is_retried(pipeline):
    outcomes, inj = _serve("broker_read", pipeline=pipeline)
    assert outcomes == ["ok", "ok"]
    assert inj.injected("broker_read") == 1
    assert inj.count("broker_read") > 1


def test_a_device_execute_fault_in_the_classic_engine(recorders):
    outcomes, inj = _serve("device_execute", pipeline=False)
    # the classic loop retries a failed batch entry by entry: the retry is
    # the second call, which runs
    assert outcomes == ["ok", "ok"]
    assert inj.count("device_execute") == 3


@pytest.fixture(scope="module")
def tiny_lm():
    return DecoderLM.tiny(generator=torch.Generator().manual_seed(0),
                          device="cpu")


def _llm(model):
    return LLMServing(model, LLMServingConfig(
        num_blocks=64, block_size=8, max_active=4, max_model_len=256,
        prefill_chunk_tokens=16, prefix_cache=True),
        broker=InMemoryBroker(), device="cpu")


@pytest.mark.parametrize("point", ["decode_step", "prefix_match",
                                   "prefill_chunk"])
def test_an_llm_fault_errors_its_step_and_the_books_balance(
        point, tiny_lm, recorders):
    eng = _llm(tiny_lm)
    cli = GenerationClient(broker=eng.broker)
    prompt = list(range(1, 41))
    eng.start()
    try:
        inj = tchaos.ChaosInjector()
        if point == "decode_step":
            # armed once the sequence is decoding: the next engine step
            # faults with the sequence slotted
            cli.submit("faulted", prompt, 24)
            stream = cli.stream_tokens("faulted", timeout=WAIT)
            next(stream)
            inj.plan(point, times=1)
            with tchaos.installed(inj):
                with pytest.raises(ServingError, match="chaos"):
                    list(stream)
        else:
            inj.plan(point, times=1)
            with tchaos.installed(inj):
                cli.submit("faulted", prompt, 4)
                with pytest.raises(ServingError, match="chaos"):
                    list(cli.stream_tokens("faulted", timeout=WAIT))
        assert inj.injected(point) == 1
        after = cli.generate("after", prompt, 4, timeout=WAIT)
        assert len(after) == 4
        deadline = time.monotonic() + WAIT
        while eng.scheduler.has_work() and time.monotonic() < deadline:
            time.sleep(0.01)
        lk = eng.cache.leak_check()
        assert lk["tables"] == 0 and lk["held_blocks"] == 0, lk
        assert eng.cache.refcount_balance() == {}
    finally:
        eng.stop()
    assert [d["reason"] for d in recorders[1].list_dumps()] == ["chaos"]
    ev = [e for e in tobs.get_tracer().export_events()
          if e["kind"] == "llm.finish" and e["attrs"]["uri"] == "faulted"]
    assert [e["attrs"]["code"] for e in ev] == ["error"]


def test_a_checkpoint_write_fault_is_retried_to_the_same_weights(tmp_path):
    from analytics_zoo_tpu_torch.data.featureset import FeatureSet
    from analytics_zoo_tpu_torch.estimator.estimator import Estimator
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    rs = np.random.default_rng(0)
    x = rs.standard_normal((32, 4)).astype(np.float32)
    y = rs.integers(0, 3, 32).astype(np.int32)

    def run(ckdir, inj):
        net = _Net()
        est = Estimator(net, SGD(lr=0.1), "sparse_categorical_crossentropy",
                        checkpoint_dir=ckdir, device="cpu")
        with tchaos.installed(inj):
            est.train(FeatureSet.from_ndarrays(x, y, shuffle=False),
                      batch_size=8, epochs=2)
        return net.w.detach().clone(), est

    clean, _ = run(None, tchaos.ChaosInjector())
    # write 0 is the step-0 bootstrap (before the loop); write 1, at the
    # end of the first epoch, faults and the epoch is retried from it
    inj = tchaos.ChaosInjector().plan("checkpoint_write", at=[1])
    faulted, est = run(str(tmp_path / "ck"), inj)
    assert inj.injected("checkpoint_write") == 1
    assert inj.count("checkpoint_write") == 4
    assert est.global_step == 8
    assert torch.equal(faulted, clean)
    spans = {s["span_id"]: s for s in tobs.get_tracer().export()}
    retry = [s for s in spans.values() if s["name"] == "train.retry"]
    assert len(retry) == 1
    failed = spans[retry[0]["parent_id"]]
    assert failed["name"] == "train.epoch" and "ChaosError" in \
        failed["error"]
