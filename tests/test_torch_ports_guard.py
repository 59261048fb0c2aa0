"""No port test binds a fixed TCP port.

The JAX package's serving tests bind fixed ports (19123, 19321-19323,
11173+, 19603-19624, 19700+, 19800+, ...) and the suite runs six files
at once, so a port test that binds a literal port, or builds a
``ServingFrontend`` at its default port, can take one of those ports
from a JAX test running beside it.  Every server in a
``tests/test_torch_*.py`` binds port 0 and its clients read ``fe.port``.
This reads every such file and fails on a literal nonzero ``port=``, a
literal ``host:port`` address, or a ``ServingFrontend(...)`` call
without ``port=0``.
"""

import glob
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PORT_KW = re.compile(r"\bport\s*=\s*(\d+)")
ADDRESS = re.compile(r"(?:127\.0\.0\.1|localhost|0\.0\.0\.0)[\"']?\s*[:,]"
                     r"\s*(\d{2,5})\b")
FRONTEND = "ServingFrontend" + "("


def _call_text(src: str, start: int) -> str:
    """The argument text of the call whose ``(`` is at ``start - 1``."""
    depth, i = 1, start
    while depth and i < len(src):
        depth += {"(": 1, ")": -1}.get(src[i], 0)
        i += 1
    return src[start:i - 1]


def port_findings(src: str):
    """``(line, what)`` for every fixed port in one test file's text."""
    out = []
    line = lambda pos: src.count("\n", 0, pos) + 1
    for m in PORT_KW.finditer(src):
        if int(m.group(1)) != 0:
            out.append((line(m.start()), m.group(0)))
    for m in ADDRESS.finditer(src):
        out.append((line(m.start()), m.group(0)))
    pos = src.find(FRONTEND)
    while pos != -1:
        args = _call_text(src, pos + len(FRONTEND))
        if not re.search(r"\bport\s*=\s*0\b", args):
            out.append((line(pos), FRONTEND + args[:40]))
        pos = src.find(FRONTEND, pos + 1)
    return out


FILES = sorted(p for p in glob.glob(os.path.join(HERE, "test_torch_*.py"))
               if os.path.basename(p) != os.path.basename(__file__))


def test_the_port_tests_are_read():
    names = {os.path.basename(p) for p in FILES}
    assert {"test_torch_http.py", "test_torch_http_llm.py",
            "test_torch_pipelined_serving.py",
            "test_torch_trace_propagation.py", "test_torch_chaos.py",
            "test_torch_memory_ledger.py",
            "test_torch_observability.py", "test_torch_model_zoo.py",
            "test_torch_tenancy.py", "test_torch_health.py",
            "test_torch_data_plane.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_no_fixed_port(path):
    with open(path) as fh:
        found = port_findings(fh.read())
    assert not found, f"{os.path.basename(path)}: fixed ports {found}"


def test_the_guard_finds_each_kind():
    bad = ("fe = " + FRONTEND + "serving).start()\n"
           "c = FastWireHttpClient(port=19123)\n"
           "conn = HTTPConnection('127.0.0.1', 11173)\n"
           "url = 'http://localhost:19603/predict'\n"
           "ok = " + FRONTEND + "serving, port=0)\n"
           "also_ok = FastWireHttpClient(port=fe.port)\n")
    assert [n for n, _ in port_findings(bad)] == [2, 3, 4, 1]
