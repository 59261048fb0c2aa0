"""The port's training triggers against the JAX package's, on the same
``TriggerState`` sequences: whether each fires, its ``next_possible_fire``
bound, their ``&`` / ``|`` compositions, and the estimator's
``_fires_in_range`` over the strides a chained dispatch takes."""

from dataclasses import replace

import pytest

from analytics_zoo_tpu.common import triggers as JT
from analytics_zoo_tpu.estimator.estimator import _fires_in_range as j_fires
from analytics_zoo_tpu_torch.common import triggers as TT
from analytics_zoo_tpu_torch.estimator.estimator import (
    _fires_in_range as t_fires)

#: (case id, factory of a trigger given the module that defines it)
TRIGGERS = {
    "EveryEpoch": lambda M: M.EveryEpoch(),
    "SeveralIteration(3)": lambda M: M.SeveralIteration(3),
    "SeveralIteration(1)": lambda M: M.SeveralIteration(1),
    "MaxEpoch(2)": lambda M: M.MaxEpoch(2),
    "MaxIteration(7)": lambda M: M.MaxIteration(7),
    "MaxScore(0.5)": lambda M: M.MaxScore(0.5),
    "MinLoss(0.3)": lambda M: M.MinLoss(0.3),
    "SeveralIteration(4)&MaxEpoch(2)":
        lambda M: M.SeveralIteration(4) & M.MaxEpoch(2),
    "SeveralIteration(5)|MaxIteration(7)":
        lambda M: M.SeveralIteration(5) | M.MaxIteration(7),
    "And(SeveralIteration(2),SeveralIteration(3))":
        lambda M: M.TriggerAnd(M.SeveralIteration(2), M.SeveralIteration(3)),
    "Or(EveryEpoch,MinLoss(0.3))":
        lambda M: M.TriggerOr(M.EveryEpoch(), M.MinLoss(0.3)),
    "Or(MaxScore(0.5),MaxEpoch(3))":
        lambda M: M.TriggerOr(M.MaxScore(0.5), M.MaxEpoch(3)),
}


def _states(M):
    """Three epochs of four steps: every step boundary, then the epoch
    end with its loss and (from the second epoch) a validation score."""
    out = []
    losses = [0.9, 0.4, 0.2]
    scores = [None, 0.45, 0.6]
    for e in range(3):
        for i in range(1, 5):
            out.append(M.TriggerState(epoch=e + 1, iteration=4 * e + i,
                                      loss=losses[e] + 0.01 * i))
        out.append(M.TriggerState(epoch=e + 1, iteration=4 * e + 4,
                                  epoch_finished=True, loss=losses[e],
                                  score=scores[e]))
    return out


@pytest.mark.parametrize("name", sorted(TRIGGERS))
def test_trigger_fires_and_bounds_as_jax(name):
    jt, tt = TRIGGERS[name](JT), TRIGGERS[name](TT)
    jstates, tstates = _states(JT), _states(TT)
    assert [tt(s) for s in tstates] == [jt(s) for s in jstates]
    for it in range(0, 16):
        assert tt.next_possible_fire(it) == jt.next_possible_fire(it), it


@pytest.mark.parametrize("name", sorted(TRIGGERS))
@pytest.mark.parametrize("k", [1, 3, 4])
def test_fires_in_range_as_jax_over_dispatch_strides(name, k):
    jt, tt = TRIGGERS[name](JT), TRIGGERS[name](TT)
    jfired, tfired = [], []
    for prev in range(0, 24, k):
        cur = prev + k
        js = JT.TriggerState(epoch=1, iteration=cur, loss=0.25)
        ts = TT.TriggerState(epoch=1, iteration=cur, loss=0.25)
        jfired.append(j_fires(jt, js, prev, cur))
        tfired.append(t_fires(tt, ts, prev, cur))
    assert tfired == jfired


def test_several_iteration_fires_once_per_covered_boundary():
    # the JAX estimator test's contract (test_estimator.py): K = 4 strides
    # over SeveralIteration(3) boundaries each fire; a stride covering no
    # boundary does not
    trig = TT.SeveralIteration(3)
    ts = TT.TriggerState(epoch=1, iteration=0)
    fired, prev = [], 0
    for cur in (4, 8, 12):
        fired.append(t_fires(trig, replace(ts, iteration=cur), prev, cur))
        prev = cur
    assert fired == [True, True, True]
    assert not t_fires(TT.SeveralIteration(100), replace(ts, iteration=8),
                       4, 8)
    assert t_fires(trig, replace(ts, iteration=3), 2, 3)
    assert not t_fires(trig, replace(ts, iteration=4), 3, 4)


def test_several_iteration_rejects_a_non_positive_interval():
    for M in (JT, TT):
        with pytest.raises(ValueError, match="positive"):
            M.SeveralIteration(0)


def test_timers_as_jax():
    from analytics_zoo_tpu.common import timer as JTimer
    from analytics_zoo_tpu_torch.common import timer as TTimer
    for M in (JTimer, TTimer):
        t = M.Timers()
        for _ in range(3):
            with t.time("step"):
                pass
        with M.time_it("x", t, log=False):
            pass
        rep = t.report()
        assert rep["step"]["count"] == 3 and rep["x"]["count"] == 1
        assert rep["step"]["mean_s"] >= 0
        t.reset()
        assert t.report() == {}
    assert isinstance(TTimer.default_timers(), TTimer.Timers)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        TTimer.Timers(metrics_prefix="zoo_train")
