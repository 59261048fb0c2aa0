"""The port's ``observability/`` against the JAX package's, on the CPU.

The same calls go to both packages' metrics registries, tracers, flight
recorders and trace CLIs.  What is a pure function of its input is held
byte for byte: Prometheus text (``render``, ``render_snapshot``,
``dump``), ``chrome_trace`` JSON and the trace CLI's output for one file.
What carries random ids (spans, trace contexts) is held by structure:
names, parent links, attributes, event kinds.  A wire trace context that
either package stamps decodes in the other.  Each recorder writes to a
``tmp_path`` of its own (both packages default to the same directory in
one process), and every test starts from fresh registries and emptied
tracers in both packages.
"""

import io
import json
import math
import sys
from contextlib import redirect_stdout

import pytest

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.observability import trace_cli as jcli
from analytics_zoo_tpu.observability import tracing as jtracing
from analytics_zoo_tpu_torch import observability as tobs
from analytics_zoo_tpu_torch.observability import trace_cli as tcli
from analytics_zoo_tpu_torch.observability import tracing as ttracing

BOTH = (jobs, tobs)


@pytest.fixture(autouse=True)
def fresh():
    """Fresh default registries, emptied enabled tracers, both packages."""
    prev = [O.set_registry(O.MetricsRegistry()) for O in BOTH]
    for O in BOTH:
        O.get_tracer().clear()
        O.set_enabled(True)
    yield
    for O, p in zip(BOTH, prev):
        O.set_enabled(True)
        O.get_tracer().clear()
        O.set_registry(p)


def _record(O, reg):
    """One fixed sequence of declarations and records on ``reg``."""
    c = reg.counter("zoo_t_requests_total", "requests by route",
                    ["route", "code"])
    c.labels(route="/predict", code="200").inc(3)
    c.labels(route='/we"ird\\path\n', code="500").inc()
    g = reg.gauge("zoo_t_depth", "queue depth", ["queue"])
    g.labels(queue="raw").set(7)
    g.labels(queue="nan").set(float("nan"))
    g.labels(queue="inf").set(float("-inf"))
    reg.gauge("zoo_t_pulled", "sampled at scrape").set_function(lambda: 2.5)
    h = reg.histogram("zoo_t_seconds", "latency")
    for v in (0.0001, 0.003, 0.25, 3.0, 400.0):
        h.observe(v)
    hb = reg.histogram("zoo_t_fill", "fill ratio", ["stage"],
                       buckets=(0.25, 0.5, 1.0))
    hb.labels(stage="a").observe(0.3)
    hb.labels(stage="a").observe(1.0)
    reg.counter("zoo_t_unused_total", "declared, never recorded")


def test_render_and_snapshot_text_are_byte_identical():
    texts = []
    for O in BOTH:
        reg = O.MetricsRegistry()
        _record(O, reg)
        texts.append((O.render(reg), O.render_snapshot(reg.snapshot()),
                      O.dump(reg), O.dump(O.MetricsRegistry())))
    assert texts[0] == texts[1]
    assert "# TYPE zoo_t_seconds histogram" in texts[1][0]
    assert texts[1][3] == ""


def test_default_buckets_and_the_dict_dump_match():
    assert tuple(jobs.default_buckets()) == tuple(tobs.default_buckets())
    snaps = []
    for O in BOTH:
        reg = O.MetricsRegistry()
        _record(O, reg)
        snap = O.dump(reg, fmt="dict")
        snaps.append(repr(sorted((name, fam["kind"], fam["help"],
                                  sorted(fam["series"].items(), key=repr))
                                 for name, fam in snap.items())))
        with pytest.raises(ValueError):
            O.dump(reg, fmt="xml")
    assert snaps[0] == snaps[1]


def test_lazy_handles_follow_set_registry_and_disable():
    outs = []
    for O in BOTH:
        lazy = O.lazy_counter("zoo_t_lazy_total", "lazy", ["k"])
        lazy.labels(k="a").inc()
        first = O.get_registry()
        prev = O.set_registry(O.MetricsRegistry())
        try:
            lazy.labels(k="a").inc(2)
            O.set_enabled(False)
            lazy.labels(k="a").inc(5)
            with O.span("off") as s:
                assert s is None
            assert O.add_event("off") is None
            O.set_enabled(True)
            outs.append((O.render(first), O.render()))
        finally:
            O.set_enabled(True)
            O.set_registry(prev)
    assert outs[0] == outs[1]
    assert 'zoo_t_lazy_total{k="a"} 2' in outs[1][1]


def _spans(O):
    """One fixed span tree on a fresh tracer: nesting, an event, an error,
    a wire parent and a bare-id handoff."""
    tr = O.Tracer(capacity=16)
    with tr.span("root", batch=4) as root:
        with tr.span("child", k=1):
            tr.add_event("tick", n=2)
        try:
            with tr.span("boom"):
                raise ValueError("x")
        except ValueError:
            pass
    with tr.span("handoff", parent=root.span_id):
        pass
    with tr.span("wire", parent=(12345, 0)):
        pass
    return tr


def _structure(spans):
    """Names, parent names, same-trace-as-parent, attrs, error and event
    kinds: everything but the ids and times."""
    by_id = {s["span_id"]: s for s in spans}
    out = []
    for s in spans:
        parent = by_id.get(s["parent_id"])
        out.append((s["name"], parent["name"] if parent else None,
                    parent is None or parent["trace_id"] == s["trace_id"],
                    s.get("attrs"), s.get("error"),
                    [e[1] for e in s.get("events", ())]))
    return out


def test_span_trees_have_the_jax_structure():
    jtr, ttr = _spans(jobs), _spans(tobs)
    jsp, tsp = jtr.export(), ttr.export()
    assert _structure(tsp) == _structure(jsp)
    assert [s["trace_id"] == 12345 for s in tsp] == \
        [s["trace_id"] == 12345 for s in jsp]
    assert [e["kind"] for e in ttr.export_events()] == \
        [e["kind"] for e in jtr.export_events()]
    assert set(tsp[0]) == set(jsp[0])
    for tr in (jtr, ttr):
        assert {s["name"] for s in tr.export(name="child")} == {"child"}
        assert len(tr.export(limit=2)) == 2


def _fixed_spans():
    """Exported-span dicts with fixed ids and times (as ``/spans`` serves
    them), events attached and one journal entry of its own."""
    spans = [
        {"name": "http.predict", "span_id": 1, "parent_id": None,
         "trace_id": 4611686018427387905, "start": 100.0, "end": 100.01,
         "duration_ms": 10.0, "tid": 7, "attrs": {"uri": "u-1"},
         "error": None, "events": [[100.001, "chaos.raise",
                                    {"point": "decode"}]]},
        {"name": "serving.decode", "span_id": 2, "parent_id": 1,
         "trace_id": 4611686018427387905, "start": 100.002,
         "end": 100.004, "duration_ms": 2.0, "tid": 8,
         "attrs": {"records": 1}, "error": None, "events": []},
        {"name": "train.step", "span_id": 3, "parent_id": None,
         "trace_id": 3, "start": 101.0, "end": 101.5, "duration_ms": 500.0,
         "tid": 9, "attrs": {"steps": 4}, "error": "ValueError: x",
         "events": []},
    ]
    events = [{"ts": 100.001, "kind": "chaos.raise", "span_id": 1,
               "trace_id": 4611686018427387905,
               "attrs": {"point": "decode"}},
              {"ts": 100.5, "kind": "shed", "span_id": None,
               "trace_id": 77, "attrs": {"records": 2}}]
    counters = [{"name": "mem:kv_blocks", "ts": 100.2,
                 "values": {"used_bytes": 4096, "pinned_bytes": 1024}}]
    return spans, events, counters


def test_chrome_trace_is_byte_identical():
    spans, events, counters = _fixed_spans()
    outs = [json.dumps(O.chrome_trace(spans, events, counters=counters))
            for O in BOTH]
    assert outs[0] == outs[1]
    assert json.dumps(jobs.chrome_trace(spans)) == \
        json.dumps(tobs.chrome_trace(spans))


@pytest.mark.parametrize("value", [
    "4611686018427387905-17", "3-0", "0-0", "12-", "-5-6", "abc", "1-x",
    "", None, "  7-8", "99999999999999999999-1"])
def test_trace_context_decodes_as_jax(value):
    assert tobs.decode_trace_context(value) == \
        jobs.decode_trace_context(value)


def test_trace_contexts_cross_decode_both_ways():
    for mint, read in ((jobs, tobs), (tobs, jobs)):
        ref = mint.new_trace_context()
        assert ref[0] >= 1 << 62 and ref[1] == 0
        wire = mint.encode_trace_context(ref)
        assert read.decode_trace_context(wire) == ref
        assert read.encode_trace_context(ref) == wire
        with mint.span("stamped") as sp:
            wire = mint.encode_trace_context(sp)
        assert read.decode_trace_context(wire) == (sp.trace_id, sp.span_id)
        # a span of the reader parented to the writer's context joins its
        # trace
        with read.span("joined", parent=read.decode_trace_context(wire)) \
                as child:
            assert (child.trace_id, child.parent_id) == \
                (sp.trace_id, sp.span_id)


def _recorder_run(O, tmp_path):
    rec = O.FlightRecorder(dir=str(tmp_path), max_dumps=3, span_limit=4,
                           event_limit=4)
    with O.span("faulted", k=1):
        O.add_event("chaos.raise", point="decode")
        first = rec.trigger("chaos", detail="decode:raise")
    paths = [rec.trigger("manual", detail=str(i)) for i in range(4)]
    limited = (rec.trigger("flappy", min_interval_s=60.0),
               rec.trigger("flappy", min_interval_s=60.0))
    listed = rec.list_dumps()
    dump = rec.read_dump(listed[0]["file"])
    for bad in ("../x.json", "not-a-dump.json", listed[0]["file"] + "/"):
        with pytest.raises(KeyError):
            rec.read_dump(bad)
    rec.enabled = False
    off = rec.trigger("off")
    return dict(first=first is not None, paths=all(paths),
                limited=(limited[0] is not None, limited[1]),
                reasons=[d["reason"] for d in listed],
                details=[rec.read_dump(d["file"])["detail"]
                         for d in listed],
                keys=sorted(dump), off=off,
                metric=O.get_registry().snapshot()[
                    "zoo_flightrecorder_dumps_total"]["series"])


def test_flight_recorder_keys_cap_rate_limit_and_traversal(tmp_path):
    got = [_recorder_run(O, tmp_path / name)
           for O, name in zip(BOTH, ("jax", "torch"))]
    assert got[0] == got[1]
    assert got[1]["reasons"] == ["manual", "manual", "flappy"]
    assert got[1]["details"] == ["2", "3", None]
    assert got[1]["keys"] == ["active_span", "detail", "events", "memory",
                              "metrics", "reason", "spans", "ts"]
    assert got[1]["limited"] == (True, None) and got[1]["off"] is None


def test_flight_recorder_dump_carries_the_faulted_span(tmp_path):
    rec = tobs.FlightRecorder(dir=str(tmp_path))
    tobs.histogram("zoo_t_seconds", "latency").observe(0.5)
    with tobs.span("serving.dispatch", records=2):
        tobs.add_event("chaos.raise", point="device_execute")
        rec.trigger("chaos", detail="device_execute:raise")
    raw = (tmp_path / rec.list_dumps()[0]["file"]).read_text()
    d = json.loads(raw)
    assert d["active_span"]["name"] == "serving.dispatch"
    assert [e[1] for e in d["active_span"]["events"]] == ["chaos.raise"]
    assert "zoo_trace_events_total" in d["metrics"]
    # strict JSON on disk: the +Inf bucket ships as a string
    assert "Infinity" not in raw and '"+Inf"' in raw


def _cli(cli, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def test_trace_cli_prints_as_the_jax_cli(tmp_path):
    spans, events, _ = _fixed_spans()
    dump = {"reason": "chaos", "detail": "decode:raise", "ts": 100.6,
            "active_span": dict(spans[0], end=None, duration_ms=None),
            "spans": spans[1:], "events": events, "metrics": {},
            "memory": {"snapshot": {"pools": {"kv_blocks": {
                "capacity_bytes": 1 << 20, "used_bytes": 4096,
                "pinned_bytes": 1024, "blocks": 4, "pressure": "ok",
                "owners": {"seq:a": 4096}}}},
                "rings": {"kv_blocks": [[100.2, 4096, 1024]]},
                "diverged": [], "last_reconcile_ms": 0.5}}
    path = tmp_path / "dump.json"
    path.write_text(json.dumps(dump))
    for argv in (["--file", str(path)],
                 ["--file", str(path), "--trace-id", "4611686018427387905"],
                 ["--file", str(path), "--trace-id", "5"]):
        assert _cli(tcli, argv) == _cli(jcli, argv)
    outs = []
    for cli, name in ((jcli, "j.json"), (tcli, "t.json")):
        rc, text = _cli(cli, ["--file", str(path), "--chrome-trace",
                              str(tmp_path / name)])
        assert rc == 0
        outs.append((text.replace(name, "X"),
                     (tmp_path / name).read_bytes()))
    assert outs[0] == outs[1]


def test_module_surface_matches_jax():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    assert tobs.CONTENT_TYPE == jobs.CONTENT_TYPE
    # the JAX hook returns False where jax.monitoring is missing; the port
    # compiles no XLA program and installs nothing
    assert tobs.install_jax_compile_hook() is False
    assert "zoo_jax_compile_events_total" not in tobs.render()
    assert sorted(n for n in dir(ttracing) if not n.startswith("_")) == \
        sorted(n for n in dir(jtracing) if not n.startswith("_"))


class _Monitor:
    def __init__(self, ok):
        self.ok = ok

    def status(self):
        return {"healthy": self.ok, "probes": 3, "last_probe_ts": 1.0,
                "devices": {"0": {"ok": self.ok}, "1": {"ok": True}}}


def test_health_gauges_render_as_jax():
    texts = []
    for O in BOTH:
        mon = _Monitor(False)
        O.install_health_gauges(mon)
        O.install_health_gauges(mon)          # idempotent
        texts.append(O.render())
    assert texts[0] == texts[1]
    assert 'zoo_device_healthy{device="0"} 0' in texts[1]


def test_registry_kind_mismatch_and_nonfinite_render_as_jax():
    errs, lines = [], []
    for O in BOTH:
        reg = O.MetricsRegistry()
        reg.counter("zoo_t_x_total", "x")
        try:
            reg.gauge("zoo_t_x_total", "x")
        except Exception as exc:
            errs.append(type(exc).__name__)
        reg.gauge("zoo_t_v").set(math.inf)
        lines.append(O.render(reg))
    assert len(errs) == 2 and errs[0] == errs[1]
    assert lines[0] == lines[1] and "zoo_t_v +Inf" in lines[1]
    assert "analytics_zoo_tpu." not in " ".join(
        m for m in sys.modules if m.startswith("analytics_zoo_tpu_torch"))
