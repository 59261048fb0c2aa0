"""``dev/trace`` — pull spans from a serving frontend or a file and make
them readable.

A copy of ``analytics_zoo_tpu/observability/trace_cli.py``, unchanged but
for its imports: for the same file it prints the same output.  Run it as
``python -m analytics_zoo_tpu_torch.observability.trace_cli``.

The one-command answer to "where did this request's time go":

    dev/trace --serve-url http://host:10020 --trace-id 4611686018427387905
    dev/trace --file /tmp/zoo-flightrecorder-123/flight_...chaos.json
    dev/trace --serve-url ... --chrome-trace out.json   # chrome://tracing

Sources:

- ``--serve-url`` fetches ``GET <url>/spans`` (server-side ``trace_id``
  filtering when ``--trace-id`` is given);
- ``--file`` reads a JSON file carrying a ``spans`` list — a saved
  ``/spans`` response, an ``export()`` dump, or a flight-recorder dump
  (whose ``active_span`` and ``events`` are folded in).

Output: an indented per-trace tree (parent links resolved, durations,
attrs, span events) on stdout, and/or ``--chrome-trace out.json`` for
``chrome://tracing`` / Perfetto.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.observability.tracing import chrome_trace

__all__ = ["main"]


def _load(args) -> Tuple[List[Dict], List[Dict], Optional[Dict]]:
    if args.serve_url:
        url = args.serve_url.rstrip("/") + "/spans"
        params = []
        if args.trace_id is not None:
            params.append(f"trace_id={args.trace_id}")
        if args.limit is not None:
            params.append(f"limit={args.limit}")
        if params:
            url += "?" + "&".join(params)
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            data = json.load(resp)
    else:
        with open(args.file) as fh:
            data = json.load(fh)
    spans = list(data.get("spans") or [])
    events = list(data.get("events") or [])
    active = data.get("active_span")
    if active:
        # a flight-recorder dump's faulted span is unfinished and not in
        # the ring — fold it in so the tree shows the crash site
        spans.append({**active, "name": active.get("name", "?")
                      + " [active]"})
    # a flight-recorder dump carries the memory ledger's forensic
    # section (pool books, sampler rings, sentinel state) — surface it
    memory = data.get("memory") or None
    return spans, events, memory


def _filter(spans, events, trace_id: Optional[int]):
    if trace_id is None:
        return spans, events
    return ([s for s in spans if s.get("trace_id") == trace_id],
            [e for e in events if e.get("trace_id") == trace_id])


def _fmt_attrs(attrs) -> str:
    return " ".join(f"{k}={v}" for k, v in (attrs or {}).items())


def _fmt_span(s: Dict) -> str:
    dur = s.get("duration_ms")
    dur_s = f"{dur:.2f}ms" if isinstance(dur, (int, float)) else "…"
    bits = [s.get("name", "?"), dur_s]
    a = _fmt_attrs(s.get("attrs"))
    if a:
        bits.append(a)
    if s.get("error"):
        bits.append(f"ERROR: {s['error']}")
    return " ".join(str(b) for b in bits)


def _print_tree(spans: Sequence[Dict], events: Sequence[Dict],
                out) -> None:
    by_trace: Dict[int, List[Dict]] = {}
    for s in spans:
        by_trace.setdefault(s.get("trace_id", 0), []).append(s)
    journal_only = [e for e in events
                    if e.get("trace_id") not in by_trace]
    for trace_id in sorted(by_trace):
        members = sorted(by_trace[trace_id],
                         key=lambda s: s.get("start", 0.0))
        ids = {s["span_id"] for s in members}
        children: Dict[int, List[Dict]] = {}
        roots = []
        for s in members:
            pid = s.get("parent_id")
            if pid in ids:
                children.setdefault(pid, []).append(s)
            else:
                roots.append(s)
        total = sum(s.get("duration_ms") or 0.0 for s in roots)
        print(f"trace {trace_id}  ({len(members)} spans, "
              f"{total:.2f}ms root time)", file=out)

        def walk(s, depth):
            t0 = s.get("start", 0.0)
            print("  " * depth + "- " + _fmt_span(s), file=out)
            for ts, name, attrs in s.get("events", ()):
                a = _fmt_attrs(attrs)
                print("  " * (depth + 1)
                      + f"· {name} +{1e3 * (ts - t0):.2f}ms"
                      + (f" {a}" if a else ""), file=out)
            for c in children.get(s["span_id"], ()):
                walk(c, depth + 1)

        for r in roots:
            walk(r, 1)
        # journal entries of this trace that no LISTED span carries
        # inline: unattached events (span_id None) AND events whose span
        # rolled off the ring / is still open — fault evidence must not
        # vanish from the tree just because its span is absent
        for e in events:
            if (e.get("trace_id") == trace_id
                    and e.get("span_id") not in ids):
                a = _fmt_attrs(e.get("attrs"))
                print(f"  · {e.get('kind', '?')}"
                      + (f" {a}" if a else ""), file=out)
    if journal_only:
        print(f"journal ({len(journal_only)} unattached events)",
              file=out)
        for e in journal_only:
            a = _fmt_attrs(e.get("attrs"))
            print(f"  · {e.get('kind', '?')}" + (f" {a}" if a else ""),
                  file=out)


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _print_memory(memory: Dict, out) -> None:
    """Render a flight dump's ``memory`` section: one line per pool
    (books + pressure + top owners), then the sentinel verdict."""
    snap = memory.get("snapshot") or {}
    pools = snap.get("pools") or {}
    diverged = memory.get("diverged") or []
    print(f"memory ({len(pools)} pools"
          + (f", DIVERGED: {', '.join(diverged)}" if diverged else "")
          + ")", file=out)
    for name in sorted(pools):
        p = pools[name]
        line = (f"  - {name}: {_fmt_bytes(p.get('used_bytes', 0))}"
                f"/{_fmt_bytes(p.get('capacity_bytes', 0))} used, "
                f"{_fmt_bytes(p.get('pinned_bytes', 0))} pinned, "
                f"{p.get('blocks', 0)} blocks "
                f"[{p.get('pressure', '?')}]")
        print(line, file=out)
        for owner, nbytes in sorted((p.get("owners") or {}).items(),
                                    key=lambda kv: -kv[1]):
            print(f"      {owner}: {_fmt_bytes(nbytes)}", file=out)
    lrm = memory.get("last_reconcile_ms")
    if lrm is not None:
        print(f"  last reconcile sweep: {lrm:.2f}ms", file=out)


def _memory_counters(memory: Dict) -> List[Dict]:
    """The dump's sampler rings as ``chrome_trace`` counter samples —
    the same shape ``MemoryLedger.counter_events`` emits live."""
    out: List[Dict] = []
    for pool, ring in (memory.get("rings") or {}).items():
        for ts, used, pinned in ring:
            out.append({"name": f"mem:{pool}", "ts": ts,
                        "values": {"used_bytes": used,
                                   "pinned_bytes": pinned}})
    out.sort(key=lambda c: c["ts"])
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dev/trace",
        description="inspect zoo trace spans (tree view / Chrome trace)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--serve-url",
                     help="serving frontend base URL (GET <url>/spans)")
    src.add_argument("--file",
                     help="JSON file with a spans list (/spans response "
                          "or flight-recorder dump)")
    ap.add_argument("--trace-id", type=int, default=None,
                    help="only this trace's spans/events")
    ap.add_argument("--limit", type=int, default=None,
                    help="most recent N spans (server-side with "
                         "--serve-url)")
    ap.add_argument("--chrome-trace", metavar="OUT.json",
                    help="write chrome://tracing / Perfetto JSON here")
    ap.add_argument("--timeout", type=float, default=10.0,
                    help="HTTP timeout seconds (default 10)")
    args = ap.parse_args(argv)
    try:
        spans, events, memory = _load(args)
    except (OSError, ValueError) as exc:
        print(f"dev/trace: could not load spans: {exc}", file=sys.stderr)
        return 2
    spans, events = _filter(spans, events, args.trace_id)
    if not spans and not events and not memory:
        print("dev/trace: no spans matched", file=sys.stderr)
        return 1
    if args.chrome_trace:
        counters = _memory_counters(memory) if memory else []
        with open(args.chrome_trace, "w") as fh:
            json.dump(chrome_trace(spans, events, counters=counters), fh)
        print(f"wrote {args.chrome_trace} "
              f"({len(spans)} spans, {len(events)} journal events, "
              f"{len(counters)} memory counter samples) — "
              "load it in chrome://tracing or ui.perfetto.dev")
    else:
        try:
            _print_tree(spans, events, sys.stdout)
            if memory:
                _print_memory(memory, sys.stdout)
        except BrokenPipeError:
            # piped into head/less and the reader closed first — the
            # unix-normal early exit, not an error
            import os
            try:
                sys.stdout.close()
            except BrokenPipeError:
                os._exit(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
