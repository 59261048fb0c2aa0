"""Prometheus text-format exposition (version 0.0.4) + dump() API.

A copy of ``analytics_zoo_tpu/observability/exposition.py``, unchanged
but for its imports: the same registry state renders to the same bytes
in either package.

``render(registry)`` produces the exact text a Prometheus scraper parses;
``GET /metrics`` on ``ServingFrontend`` serves it.  ``dump()`` is the
non-HTTP surface: the same text (or the structured snapshot) for log
shippers, tests, and in-notebook inspection.
"""

from __future__ import annotations

from typing import Optional

from analytics_zoo_tpu_torch.observability.metrics import (
    MetricsRegistry, get_registry)

__all__ = ["render", "render_snapshot", "dump", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r"\""))


def _fmt(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labelstr(names, values, extra=()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"'
             for n, v in list(zip(names, values)) + list(extra)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry's current state in Prometheus text format."""
    reg = registry or get_registry()
    reg.collect()
    lines = []
    for fam in reg.families():
        lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for child in fam.children():
            ls = _labelstr(fam.labelnames, child.labelvalues)
            if fam.kind == "histogram":
                snap = child.snapshot()
                for le, cum in snap["buckets"]:
                    bl = _labelstr(fam.labelnames, child.labelvalues,
                                   extra=[("le", _fmt(le))])
                    lines.append(f"{fam.name}_bucket{bl} {cum}")
                lines.append(f"{fam.name}_sum{ls} {_fmt(snap['sum'])}")
                lines.append(f"{fam.name}_count{ls} {snap['count']}")
            else:
                lines.append(f"{fam.name}{ls} {_fmt(child.value)}")
    # an empty registry exposes an empty body, not a lone newline (the
    # text format is a sequence of lines; zero lines is zero bytes)
    return "\n".join(lines) + "\n" if lines else ""


def render_snapshot(snapshot: dict) -> str:
    """A ``MetricsRegistry.snapshot()``-shaped dict in Prometheus text
    format — the exposition path for snapshots that did NOT come from a
    live local registry (the fleet tier merges per-process snapshots
    broker-side and any worker renders the union, docs/serving.md
    "Fleet tier").  Emits the same lines ``render`` would for a registry
    in that state."""
    lines = []
    for name, fam in snapshot.items():
        lines.append(f"# HELP {name} {_escape_help(fam.get('help', ''))}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for key, value in fam["series"].items():
            names = [n for n, _ in key]
            values = [v for _, v in key]
            ls = _labelstr(names, values)
            if fam["kind"] == "histogram":
                for le, cum in value["buckets"]:
                    bl = _labelstr(names, values, extra=[("le", _fmt(le))])
                    lines.append(f"{name}_bucket{bl} {cum}")
                lines.append(f"{name}_sum{ls} {_fmt(value['sum'])}")
                lines.append(f"{name}_count{ls} {value['count']}")
            else:
                lines.append(f"{name}{ls} {_fmt(value)}")
    return "\n".join(lines) + "\n" if lines else ""


def dump(registry: Optional[MetricsRegistry] = None,
         fmt: str = "text"):
    """Non-HTTP exposition: ``fmt="text"`` returns the Prometheus text,
    ``fmt="dict"`` the structured ``snapshot()``."""
    reg = registry or get_registry()
    if fmt == "text":
        return render(reg)
    if fmt == "dict":
        return reg.snapshot()
    raise ValueError(f"unknown dump format {fmt!r}; use 'text' or 'dict'")
