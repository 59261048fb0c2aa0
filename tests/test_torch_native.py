"""The port's host library against the JAX package's.

``analytics_zoo_tpu_torch.native`` builds its own copy of the two C++
sources into the package's ``_build/`` directory; the JAX loader builds
``libzoo_native.so`` beside its sources.  Both load into this process
(``RTLD_LOCAL`` keeps their ``zoo_*`` symbols apart), and the same scripts
of calls must give the same outputs through both: CRC-32C, the request
queue and the tiered sample cache, and the host image ops.
"""

import os
import threading

import numpy as np
import pytest

from analytics_zoo_tpu import native as jnative
from analytics_zoo_tpu_torch import native as tnative


def test_crc32c_matches_jax_on_seeded_bytes():
    rng = np.random.default_rng(0)
    cases = [b"", b"123456789"] + [
        rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
        for n in rng.integers(1, 4096, 64)]
    got = [tnative.crc32c(c) for c in cases]
    assert got == [jnative.crc32c(c) for c in cases]
    assert got[1] == 0xE3069283            # the CRC-32C check value


def _queue_script(mod):
    """One script of pushes, partial pops, timeouts, completions, waits
    and a close that drains; returns everything it observed."""
    q = mod.RequestQueue()
    out = []
    try:
        for i in range(1, 6):
            q.push(i, bytes([i]) * i)
        q.push(7, b"p1", part=1)
        out.append(q.pop_batch(3, timeout_ms=10))
        out.append(q.pop_batch(8, timeout_ms=10))
        out.append(q.pop_batch(8, timeout_ms=10))          # empty: []
        out.append(q.pop_batch(8, timeout_ms=10, part=1))
        for i in (1, 3, 7):
            q.complete(i, b"done-%d" % i)
        out.append([q.wait(i, timeout_ms=50) for i in (1, 3, 7, 2)])
        stats = q.stats()
        out.append({k: int(v) for k, v in stats.items()})
        q.push(9, b"last")
        q.close()
        out.append(q.pop_batch(8, timeout_ms=10))          # drains
        out.append(q.pop_batch(8, timeout_ms=10))          # None: closed
        with pytest.raises(RuntimeError, match="closed"):
            q.push(10, b"late")
    finally:
        q.destroy()
    return out


def test_request_queue_script_matches_jax():
    got = _queue_script(tnative)
    assert got == _queue_script(jnative)
    assert got[0] == [(1, b"\x01"), (2, b"\x02\x02"), (3, b"\x03" * 3)]
    assert got[2] == [] and got[-1] is None
    assert got[4] == [b"done-1", b"done-3", b"done-7", None]


def _cache_script(mod, spill_dir):
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((16, 16)).astype(np.float32)
            for _ in range(6)]
    c = mod.NativeSampleCache(3 * arrs[0].nbytes, spill_dir)
    out = []
    try:
        for i, a in enumerate(arrs):
            c.put(i, a)
        out.append(dict(c.stats()))
        out.append(c.recount())
        out.append(len(c))
        for i in (0, 5, 2, 9):
            got = c.get(i, shape=(16, 16))
            out.append(None if got is None else got.tobytes())
        out.append(dict(c.stats()))
        out.append([c.remove(i) for i in (1, 1, 42)])
        out.append(c.recount())
        out.append(len(c))
    finally:
        c.close()
    return out


def test_sample_cache_script_matches_jax(tmp_path):
    got = _cache_script(tnative, str(tmp_path / "port"))
    assert got == _cache_script(jnative, str(tmp_path / "jax"))
    assert got[0]["spills"] > 0                 # the DRAM budget spilled
    assert got[3] is not None and got[6] is None    # 9 was never put
    assert got[-3] == [True, False, False]


def test_image_ops_match_jax():
    rng = np.random.default_rng(2)
    img = rng.random((17, 23, 3), dtype=np.float32)
    np.testing.assert_array_equal(tnative.resize_bilinear(img, 9, 31),
                                  jnative.resize_bilinear(img, 9, 31))
    np.testing.assert_array_equal(tnative.crop(img, 2, 3, 8, 8),
                                  jnative.crop(img, 2, 3, 8, 8))
    mean, std = [0.5, 0.4, 0.3], [0.2, 0.25, 0.3]
    np.testing.assert_array_equal(tnative.normalize(img, mean, std),
                                  jnative.normalize(img, mean, std))
    with pytest.raises(ValueError, match="out of bounds"):
        tnative.crop(img, 10, 0, 8, 8)


def test_library_is_built_under_its_hash_not_beside_the_sources():
    path = tnative.load_library()._name
    assert path == tnative.library_path()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert os.path.basename(path).startswith("libzoo_native-")
    here = os.path.dirname(tnative.__file__)
    assert sorted(n for n in os.listdir(here) if n != "__pycache__") == \
        sorted(["__init__.py", *tnative.SOURCES])


def test_a_changed_flag_names_another_library(monkeypatch):
    before = tnative.library_path()
    monkeypatch.setattr(tnative, "GXX_FLAGS", (*tnative.GXX_FLAGS, "-g"))
    assert tnative.library_path() != before


def test_two_threads_building_at_once_leave_one_loadable_library(
        tmp_path, monkeypatch):
    import ctypes
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    got, errs = [], []
    start = threading.Barrier(2)

    def build():
        try:
            start.wait()
            got.append(tnative.build())
        except Exception as exc:        # pragma: no cover
            errs.append(exc)
    ts = [threading.Thread(target=build) for _ in range(2)]
    [t.start() for t in ts]
    [t.join(timeout=120) for t in ts]
    assert not errs and len(set(got)) == 1
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(got[0]), "libzoo_native.lock"])
    lib = ctypes.CDLL(got[0])
    lib.zoo_crc32c.restype = ctypes.c_uint32
    lib.zoo_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    assert lib.zoo_crc32c(b"123456789", 9) == 0xE3069283


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "src"
    bad.mkdir()
    (bad / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_HERE", str(bad))
    monkeypatch.setattr(tnative, "SOURCES", ("broken.cpp",))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="native build failed.*broken"):
        tnative.build()
    assert [n for n in os.listdir(tmp_path / "build")
            if not n.endswith(".lock")] == []      # no half-built file
