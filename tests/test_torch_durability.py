"""The write-ahead log, the journaled broker and its warm standby against
the JAX package's.

- The WAL core's cases of the JAX suite on the port's ``WriteAheadLog``:
  framing, segment rolls, group commit, and the torn tail cut at every
  byte offset of a real log's last record.
- One on-disk format: a log the JAX package wrote replays in the port,
  and one the port wrote replays in the JAX package.
- ``DurableBroker``: one op script through both packages gives the same
  reads, pending ledgers, dedup drops, and the same state after reopen
  and after ``checkpoint()``.
- ``BrokerReplica``: tails a primary over a bridge on port 0 and promotes
  with the disk catch-up, also across the two packages.
- The chaos points ``wal_append``, ``wal_replay`` and ``broker_promote``
  behave as the JAX package's.
"""

import os
import shutil
import threading
import time

import pytest

from analytics_zoo_tpu.common import wal as jwal
from analytics_zoo_tpu.serving import durability as jdur
from analytics_zoo_tpu.serving.fleet import BrokerBridge as JBridge
from analytics_zoo_tpu.testing import chaos as jchaos
from analytics_zoo_tpu_torch import observability as obs
from analytics_zoo_tpu_torch.common import wal as twal
from analytics_zoo_tpu_torch.common.wal import (
    WriteAheadLog, _HDR, list_segments)
from analytics_zoo_tpu_torch.serving import durability as tdur
from analytics_zoo_tpu_torch.serving.durability import (
    BrokerReplica, DurableBroker, replay_dir)
from analytics_zoo_tpu_torch.serving.fleet import BrokerBridge
from analytics_zoo_tpu_torch.testing import chaos


def _torn_count():
    fam = obs.get_registry().snapshot().get(
        "zoo_broker_wal_torn_records_total")
    return fam["series"].get((), 0) if fam else 0


# ---- the WAL core ----------------------------------------------------------

class TestWalCore:
    def test_roundtrip_and_segment_roll(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path), segment_bytes=256)
        seqs = [wal.append(("rec", i, b"x" * 64)) for i in range(16)]
        assert seqs == list(range(1, 17))
        assert len(list_segments(str(tmp_path))) > 1
        got = list(wal.replay(0))
        assert [s for s, _ in got] == seqs
        assert [r[1] for _, r in got] == list(range(16))
        assert [s for s, _ in wal.tail(10, limit=3)] == [10, 11, 12]
        wal.close()

    def test_reopen_continues_sequence(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        wal.append(("a",))
        wal.append(("b",))
        wal.close()
        wal2 = WriteAheadLog(str(tmp_path))
        assert wal2.append(("c",)) == 3
        assert [r[0] for _, r in wal2.replay(0)] == ["a", "b", "c"]
        wal2.close()

    def test_torn_tail_skipped_at_every_byte_offset(self, tmp_path):
        src = tmp_path / "src"
        wal = WriteAheadLog(str(src))
        for i in range(4):
            wal.append(("keep", i))
        intact_end = os.path.getsize(list_segments(str(src))[0][1])
        wal.append(("torn", b"payload-bytes-here"))
        wal.close()
        seg = list_segments(str(src))[0][1]
        total = os.path.getsize(seg)
        assert total > intact_end + _HDR.size
        for cut in range(intact_end, total):
            case = tmp_path / f"cut-{cut}"
            case.mkdir()
            dst = case / os.path.basename(seg)
            shutil.copy(seg, dst)
            with open(dst, "rb+") as fh:
                fh.truncate(cut)
            before = _torn_count()
            got = list(replay_dir(str(case)))
            assert [r[1] for _, r in got] == [0, 1, 2, 3], cut
            if cut > intact_end:
                assert _torn_count() > before, f"cut {cut} not counted"

    def test_append_after_torn_tail_stays_visible(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        wal.append(("a",))
        wal.append(("b",))
        wal.close()
        seg = list_segments(str(tmp_path))[0][1]
        with open(seg, "rb+") as fh:
            fh.truncate(os.path.getsize(seg) - 3)
        wal2 = WriteAheadLog(str(tmp_path))
        wal2.append(("c",))
        assert [r[0] for _, r in wal2.replay(0)] == ["a", "c"]
        wal2.close()

    def test_live_tail_does_not_count_partial_records_as_torn(
            self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        wal.append(("a",))
        wal.append(("b",))
        wal.close()
        seg = list_segments(str(tmp_path))[0][1]
        with open(seg, "rb+") as fh:
            fh.truncate(os.path.getsize(seg) - 3)
        wal2 = WriteAheadLog.__new__(WriteAheadLog)
        wal2.dir = str(tmp_path)
        before = _torn_count()
        assert [r[0] for _, r in wal2.tail(0, 10)] == ["a"]
        assert _torn_count() == before          # a live tail: silent
        list(wal2.replay(0))                    # recovery: counted
        assert _torn_count() == before + 1

    def test_replay_from_seq_skips_whole_segments(self, tmp_path,
                                                  monkeypatch):
        wal = WriteAheadLog(str(tmp_path), segment_bytes=128)
        for i in range(32):
            wal.append(("r", i, b"x" * 48))
        wal.close()
        segs = list_segments(str(tmp_path))
        assert len(segs) > 3
        opened = []
        orig = twal._read_segment

        def spy(path, from_seq, count_torn=True):
            opened.append(path)
            return orig(path, from_seq, count_torn)
        monkeypatch.setattr(twal, "_read_segment", spy)
        wal2 = WriteAheadLog(str(tmp_path))
        opened.clear()
        assert [s for s, _ in wal2.tail(31, 10)] == [31, 32]
        assert len(opened) <= 2
        wal2.close()

    def test_group_commit_covers_concurrent_appenders(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path), commit_interval_ms=2.0)
        errs = []

        def worker(k):
            try:
                for i in range(25):
                    wal.append(("w", k, i))
            except Exception as exc:        # pragma: no cover
                errs.append(exc)
        ts = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        [t.start() for t in ts]
        [t.join(timeout=30) for t in ts]
        assert not errs
        assert len(list(wal.replay(0))) == 200
        wal.close()


def test_framing_and_segment_names_match_jax():
    assert (twal._MAGIC, twal._HDR.format) == (jwal._MAGIC, jwal._HDR.format)
    assert twal._segment_name(42) == jwal._segment_name(42)


def _write_records(mod, path):
    wal = mod.WriteAheadLog(str(path), segment_bytes=200)
    recs = [("xadd", "s", str(i), {"uri": f"u{i}", "data": bytes([i]) * 9})
            for i in range(12)] + [("ack", "s", "g", ["1", "2"])]
    for r in recs:
        wal.append(r)
    wal.close()
    return recs


@pytest.mark.parametrize("writer,reader", [(jwal, twal), (twal, jwal)],
                         ids=["jax-wrote", "port-wrote"])
def test_a_log_replays_in_the_other_package(tmp_path, writer, reader):
    recs = _write_records(writer, tmp_path)
    assert len(list_segments(str(tmp_path))) > 1
    got = reader.WriteAheadLog(str(tmp_path))
    assert list(got.replay(0)) == list(enumerate(recs, start=1))
    assert got.append(("after",)) == len(recs) + 1
    got.close()
    again = writer.WriteAheadLog(str(tmp_path))
    assert [r for _, r in again.replay(0)][-1] == ("after",)
    again.close()
    with open(list_segments(str(tmp_path))[0][1], "rb") as fh:
        blob = fh.read()
    assert jwal._HDR.unpack_from(blob, 0)[0] == jwal._MAGIC


# ---- DurableBroker ----------------------------------------------------------

def _broker_state(b):
    return {"streams": {k: list(v) for k, v in b._streams.items()},
            "cursors": dict(b._cursors),
            "pending": {k: {sid: (p.fields, p.deliveries)
                            for sid, p in v.items()}
                        for k, v in b._unacked.items()},
            "dedup": list(b._dedup.items()), "sid": b._sid,
            "hashes": {k: b.hgetall(k) for k in sorted(b.keys("*"))}}


def _durable_script(mod, path):
    """One op script: enqueues with dedup ids and a retry, reads, acks,
    results, a deleted key and stream; then reopen, checkpoint, reopen."""
    b = mod.DurableBroker(str(path), segment_bytes=400,
                          checkpoint_every_records=0)
    out = []
    b.xgroup_create("s", "g")
    sids = [b.xadd("s", {"uri": f"u{i}", "data": bytes([i]) * 4,
                         "dedup_id": f"d{i}"}) for i in range(6)]
    out.append(sids)
    out.append(b.xadd("s", {"uri": "u1", "dedup_id": "d1"}))   # a retry
    out.append(b.xreadgroup("s", "g", "c1", count=4, block_ms=10))
    out.append(b.xack("s", "g", sids[0], sids[2]))
    out.append(b.pending("s", "g"))
    b.xadd("tok", {"frame": b"\x01"})
    b.delete_stream("tok")
    b.set_results({"result:u0": {"value": b"\x07"},
                   "result:u2": {"error": "x", "code": "expired"}})
    b.hset("result:u2", {"scope": "tenant"})
    b.hset("result:gone", {"v": 1})
    b.delete("result:gone")
    state = _broker_state(b)
    b.close()
    b2 = mod.DurableBroker(str(path), checkpoint_every_records=0)
    out.append(_broker_state(b2) == state)
    # recovery: delivered-but-unacked entries redeliver first, then fresh
    out.append(b2.xreadgroup("s", "g", "c2", count=16, block_ms=10))
    out.append(b2.pending("s", "g"))
    b2.xack("s", "g", *b2.pending("s", "g"))
    n_segs = len(list_segments(str(path)))
    b2.checkpoint()
    out.append(len(list_segments(str(path))) <= n_segs)
    after = _broker_state(b2)
    b2.xadd("s", {"uri": "late", "dedup_id": "d-late"})
    b2.close()
    b3 = mod.DurableBroker(str(path), checkpoint_every_records=0)
    out.append(b3.xadd("s", {"uri": "u3", "dedup_id": "d3"}))  # a retry
    out.append([f["uri"] for _, f in
                b3.xreadgroup("s", "g", "c3", count=16, block_ms=10)])
    out.append(_broker_state(b3)["hashes"] == after["hashes"])
    out.append(_broker_state(b3)["hashes"])
    b3.close()
    return out


def test_durable_broker_script_matches_jax(tmp_path):
    got = _durable_script(tdur, tmp_path / "port")
    assert got == _durable_script(jdur, tmp_path / "jax")
    sids = got[0]
    assert got[1] == sids[1]                    # the retry was dropped
    assert got[4] == {sids[1]: 1, sids[3]: 1}
    assert got[5] is True                       # reopen: the same state
    assert [f["uri"] for _, f in got[6]] == ["u1", "u3", "u4", "u5"]
    assert got[7] == {sids[1]: 2, sids[3]: 2, sids[4]: 1, sids[5]: 1}
    assert got[8] is True and got[9] == sids[3]
    assert got[10] == ["late"] and got[11] is True
    assert got[12] == {"result:u0": {"value": b"\x07"},
                       "result:u2": {"error": "x", "code": "expired",
                                     "scope": "tenant"}}


@pytest.mark.parametrize("writer,reader", [(jdur, tdur), (tdur, jdur)],
                         ids=["jax-wrote", "port-wrote"])
def test_a_journaled_broker_recovers_in_the_other_package(
        tmp_path, writer, reader):
    b = writer.DurableBroker(str(tmp_path), checkpoint_every_records=0)
    b.xgroup_create("s", "g")
    for i in range(5):
        b.xadd("s", {"uri": f"u{i}", "dedup_id": f"d{i}"})
    got = b.xreadgroup("s", "g", "c", count=3, block_ms=10)
    b.xack("s", "g", got[0][0])
    b.set_results({"result:u0": {"value": b"\x00"}})
    if writer is jdur:
        b.checkpoint()                  # a snapshot record in the log
    b.xadd("s", {"uri": "u5"})
    want = _broker_state(b)
    b.close()
    r = reader.DurableBroker(str(tmp_path), checkpoint_every_records=0)
    state = _broker_state(r)
    assert state["streams"] == want["streams"]
    assert state["hashes"] == want["hashes"]
    assert state["dedup"] == want["dedup"] and state["sid"] == want["sid"]
    assert {k: {s: f for s, (f, _) in v.items()}
            for k, v in state["pending"].items()} == {
        k: {s: f for s, (f, _) in v.items()}
        for k, v in want["pending"].items()}
    assert r.xadd("s", {"uri": "u1", "dedup_id": "d1"}) == "2"
    assert [f["uri"] for _, f in
            r.xreadgroup("s", "g", "c2", count=8, block_ms=10)] == [
        "u1", "u2", "u3", "u4", "u5"]
    r.close()


def test_claim_on_death_redelivery(tmp_path):
    b = DurableBroker(str(tmp_path), redeliver_idle_s=0.2)
    b.xgroup_create("s", "g")
    b.xadd("s", {"uri": "u1"})
    assert len(b.xreadgroup("s", "g", "dead-consumer", block_ms=20)) == 1
    assert b.xreadgroup("s", "g", "live", block_ms=20) == []
    time.sleep(0.25)
    got = b.xreadgroup("s", "g", "live", block_ms=20)
    assert [f["uri"] for _, f in got] == ["u1"]
    b.xack("s", "g", got[0][0])
    assert b.pending("s", "g") == {}
    b.close()


# ---- BrokerReplica -----------------------------------------------------------

def _wait_applied(rep, seq, timeout=10.0):
    deadline = time.monotonic() + timeout
    while rep.broker.applied_seq < seq and time.monotonic() < deadline:
        time.sleep(0.02)
    assert rep.broker.applied_seq >= seq


@pytest.mark.parametrize("primary_mod,bridge_cls", [
    (tdur, BrokerBridge), (jdur, JBridge)], ids=["port", "jax-primary"])
def test_tail_promote_and_disk_catchup(tmp_path, primary_mod, bridge_cls):
    pdir, sdir = str(tmp_path / "p"), str(tmp_path / "s")
    primary = primary_mod.DurableBroker(pdir)
    primary.xgroup_create("s", "g")
    primary.xadd("s", {"uri": "u1", "data": b"\x00\x01"})
    bridge = bridge_cls(primary, port=0).start()
    rep = BrokerReplica(bridge.address, sdir, primary_wal_dir=pdir).start()
    try:
        primary.xadd("s", {"uri": "u2"})
        _wait_applied(rep, primary.wal.next_seq - 1)
        assert rep.status()["role"] == "standby"
        # the tail gap: a record the wire never carried replays from disk
        bridge.stop()
        primary.xadd("s", {"uri": "u3"})
        primary.close()
        seq = rep.promote()
        got = rep.broker.xreadgroup("s", "g", "c", count=10, block_ms=20)
        assert [f["uri"] for _, f in got] == ["u1", "u2", "u3"]
        assert got[0][1]["data"] == b"\x00\x01"
        assert rep.promote() == seq == rep.broker.applied_seq
    finally:
        rep.stop()


def test_standby_restart_recovers_applied_seq(tmp_path):
    pdir, sdir = str(tmp_path / "p"), str(tmp_path / "s")
    primary = DurableBroker(pdir)
    primary.xadd("s", {"uri": "u1"})
    bridge = BrokerBridge(primary, port=0).start()
    try:
        rep = BrokerReplica(bridge.address, sdir).start()
        _wait_applied(rep, 1)
        applied = rep.broker.applied_seq
        rep.stop()
        rep2 = BrokerReplica(bridge.address, sdir)
        assert rep2.broker.applied_seq == applied
        rep2.stop()
    finally:
        bridge.stop()
        primary.close()


# ---- chaos ------------------------------------------------------------------

def _wal_append_fault(mod, chaosmod, path):
    b = mod.DurableBroker(str(path))
    inj = chaosmod.ChaosInjector()
    inj.plan("wal_append", fault="raise", times=1)
    faults = 0
    with chaosmod.installed(inj):
        for _attempt in range(3):
            try:
                sid = b.xadd("s", {"uri": "u1", "dedup_id": "d1"})
                break
            except chaosmod.ChaosError:
                faults += 1
    b.xgroup_create("s", "g")
    got = [f["uri"] for _, f in b.xreadgroup("s", "g", "c", block_ms=20)]
    b.close()
    return faults, inj.injected("wal_append"), sid, got


def test_wal_append_fault_matches_jax(tmp_path):
    got = _wal_append_fault(tdur, chaos, tmp_path / "p")
    assert got == _wal_append_fault(jdur, jchaos, tmp_path / "j")
    # one entry despite the fault (the faulted attempt spent sid 1)
    assert got == (1, 1, "2", ["u1"])


def _wal_replay_fault(mod, chaosmod, path):
    b = mod.DurableBroker(str(path))
    for i in range(5):
        b.xadd("s", {"uri": f"u{i}"})
    b.close()
    inj = chaosmod.ChaosInjector()
    inj.plan("wal_replay", fault="raise", at=[2])
    with chaosmod.installed(inj):
        b2 = mod.DurableBroker(str(path))
    b2.xgroup_create("s", "g")
    got = [f["uri"] for _, f in
           b2.xreadgroup("s", "g", "c", count=10, block_ms=20)]
    b2.close()
    return inj.injected("wal_replay"), got


def test_wal_replay_fault_retries_as_jax_does(tmp_path):
    got = _wal_replay_fault(tdur, chaos, tmp_path / "p")
    assert got == _wal_replay_fault(jdur, jchaos, tmp_path / "j")
    assert got == (1, [f"u{i}" for i in range(5)])    # retried, not lost


def test_broker_promote_fault_is_retryable(tmp_path):
    pdir, sdir = str(tmp_path / "p"), str(tmp_path / "s")
    primary = DurableBroker(pdir)
    primary.xadd("s", {"uri": "u1"})
    bridge = BrokerBridge(primary, port=0).start()
    rep = BrokerReplica(bridge.address, sdir, primary_wal_dir=pdir).start()
    try:
        inj = chaos.ChaosInjector()
        inj.plan("broker_promote", fault="raise", times=1)
        with chaos.installed(inj):
            with pytest.raises(chaos.ChaosError):
                rep.promote()
            assert not rep.promoted
            rep.promote()
        assert rep.promoted and inj.injected("broker_promote") == 1
        got = rep.broker.xreadgroup("s", "g", "c", block_ms=20)
        assert [f["uri"] for _, f in got] == ["u1"]
    finally:
        rep.stop()
        bridge.stop()
        primary.close()
