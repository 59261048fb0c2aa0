"""Real processes: the port's multi-process bring-up on the CPU.

The port's counterpart of ``tests/test_multihost.py``: two OS processes
rendezvous through ``init_zoo_context`` at an ephemeral coordinator port
and exchange data (``parallel.distributed.process_allgather``); then a
two-process training run loses its non-coordinator mid-training, the
survivor raises within the collective timeout (no hang, no retry in
place), a fresh pair resumes at the persisted step, and one process
resumes the same checkpoint with the pair's losses (the JAX test's
``rtol=2e-4``).  ``RayContext(num_workers=2)`` starts such a pair.
Marked ``slow``: these tests start processes and bind ports.
"""

import glob
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch_mp_workers

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import sys
    pid, port = int(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, {repo!r})
    from analytics_zoo_tpu_torch.common.config import ZooConfig
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.parallel import distributed

    ctx = init_zoo_context(ZooConfig(
        coordinator_address=f"127.0.0.1:{{port}}", num_processes=2,
        process_id=pid, platform="cpu"))
    got = distributed.process_allgather(float(pid + 1))
    assert sorted(got.ravel().tolist()) == [1.0, 2.0], got
    assert (ctx.process_index, ctx.process_count, ctx.backend) == (
        pid, 2, "gloo"), ctx
    print(f"OK proc {{pid}} sees {{ctx.process_count}} processes", flush=True)
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    env.update(extra)
    return env


def _run(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:        # a hung rendezvous must not leak workers
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _spawn(code, *args, env=None):
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            env=env or _env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_two_process_rendezvous_and_allgather():
    port = _free_port()
    worker = _WORKER.format(repo=REPO)
    procs = [_spawn(worker, i, port) for i in range(2)]
    outs = _run(procs)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"OK proc {i} sees 2 processes" in out


_ELASTIC_WORKER = textwrap.dedent("""
    import os, sys, threading, time
    pid, port = int(sys.argv[1]), sys.argv[2]
    ckdir, phase = sys.argv[3], sys.argv[4]
    sys.path.insert(0, {repo!r})
    import numpy as np
    from analytics_zoo_tpu_torch.common.config import ZooConfig
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.common.triggers import SeveralIteration
    from analytics_zoo_tpu_torch.data import FeatureSet
    from analytics_zoo_tpu_torch.estimator import Estimator
    from analytics_zoo_tpu_torch.estimator.checkpoint import (
        latest_checkpoint, restore_checkpoint)
    from analytics_zoo_tpu_torch.keras import layers as L
    from analytics_zoo_tpu_torch.keras.engine import Sequential
    from analytics_zoo_tpu_torch.keras.optimizers import Adam

    if phase == "resume1":
        # one process, four positions on the host: the checkpoint of two
        # processes restores onto another topology
        init_zoo_context(ZooConfig(platform="cpu"), devices=["cpu"] * 4)
    else:
        init_zoo_context(ZooConfig(
            coordinator_address=f"127.0.0.1:{{port}}", num_processes=2,
            process_id=pid, platform="cpu"))

    rs = np.random.RandomState(0)
    x = rs.randn(64, 8).astype(np.float32)
    w = rs.randn(8, 1).astype(np.float32)
    y = (x @ w).astype(np.float32)
    net = Sequential([L.Dense(4, input_shape=(8,)), L.Dense(1)],
                     device="cpu")
    net.init(__import__("torch").Generator().manual_seed(0))
    est = Estimator(net, Adam(lr=0.01), "mse", checkpoint_dir=ckdir,
                    checkpoint_trigger=SeveralIteration(4))
    est.retry_times = 0
    fs = FeatureSet.from_ndarrays(x, y, shuffle=False)

    if phase == "crash":
        if pid == 1:
            def bomb():
                # die mid-training once a checkpoint of step >= 4 exists
                import glob
                while not [d for d in glob.glob(ckdir + "/ckpt-*")
                           if not d.endswith(".tmp")
                           and int(d.rsplit("-", 1)[1]) >= 4]:
                    time.sleep(0.02)
                os._exit(9)
            threading.Thread(target=bomb, daemon=True).start()
        try:
            est.train(fs, batch_size=8, epochs=500)
            print("TRAIN-FINISHED", flush=True)       # must not happen
            sys.exit(4)
        except BaseException as e:                    # noqa: BLE001
            print("SURVIVOR-ERRORED:", type(e).__name__, flush=True)
            sys.exit(3)
    ck = latest_checkpoint(ckdir)
    assert ck is not None, "no checkpoint survived the crash"
    bundle, start_step = restore_checkpoint(ck)
    print(f"RESTORE-STEP {{start_step}}", flush=True)
    est.train(fs, batch_size=8, epochs=int(bundle[3]["epoch"]) + 2,
              resume=True)
    assert est.global_step > start_step, (est.global_step, start_step)
    print(f"DONE-STEP {{est.global_step}}", flush=True)
    print("LOSSES " + " ".join(f"{{float(h['loss']):.8f}}"
                               for h in est.history), flush=True)
""")


def test_kill_worker_then_resume_from_checkpoint(tmp_path):
    """The non-coordinator dies mid-training: the survivor errors within
    the collective timeout (20 s here), a fresh pair resumes at the
    persisted step, and one process resumes the same checkpoint."""
    ckdir = str(tmp_path / "elastic-ck")
    worker = _ELASTIC_WORKER.format(repo=REPO)
    env = _env(ZOO_TPU_COLLECTIVE_TIMEOUT_S="20")
    port = _free_port()
    procs = [_spawn(worker, i, port, ckdir, "crash", env=env)
             for i in range(2)]
    outs = _run(procs)
    assert procs[1].returncode == 9, f"bomb didn't fire:\n{outs[1][-2000:]}"
    assert procs[0].returncode == 3, (
        f"survivor did not error:\n{outs[0][-2000:]}")
    steps = sorted(int(d.rsplit("-", 1)[1])
                   for d in glob.glob(ckdir + "/ckpt-*")
                   if not d.endswith(".tmp"))
    assert steps and steps[-1] >= 4, steps
    snap = str(tmp_path / "elastic-ck-snap")
    shutil.copytree(ckdir, snap)

    port2 = _free_port()
    procs2 = [_spawn(worker, i, port2, ckdir, "resume", env=env)
              for i in range(2)]
    outs2 = _run(procs2)
    for i, (p, out) in enumerate(zip(procs2, outs2)):
        assert p.returncode == 0, f"resume proc {i} failed:\n{out[-2000:]}"
        assert f"RESTORE-STEP {steps[-1]}" in out, out[-2000:]
        assert "DONE-STEP" in out

    proc3 = _spawn(worker, 0, 0, snap, "resume1", env=env)
    (out3,) = _run([proc3])
    assert proc3.returncode == 0, f"resume1 failed:\n{out3[-2000:]}"
    assert f"RESTORE-STEP {steps[-1]}" in out3, out3[-2000:]

    def losses(out):
        line = [ln for ln in out.splitlines() if ln.startswith("LOSSES")][-1]
        return np.array([float(v) for v in line.split()[1:]])
    same, topo = losses(outs2[0]), losses(out3)
    assert topo.shape == same.shape, (topo, same)
    np.testing.assert_allclose(topo, same, rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(losses(outs2[1]), same)


def test_ray_context_runs_two_cpu_workers():
    from analytics_zoo_tpu_torch.orca import RayContext
    rc = RayContext(num_workers=2, platform="cpu").init()
    try:
        out = rc.run(torch_mp_workers.gathered_ranks, args=(1.0,),
                     timeout=120)
    finally:
        rc.stop()
    # each worker saw both values: (0+1) + (1+1) = 3, two processes
    assert out == [(3.0, 2, "gloo"), (3.0, 2, "gloo")]
