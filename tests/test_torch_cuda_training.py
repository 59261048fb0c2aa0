"""Training on the card: the seed the flash kernels read from device
memory, the training step captured as a CUDA graph, launch counts through
its replays, and a checkpoint restored into a captured graph.

Marked ``cuda``: every test skips with a reason where no CUDA device is
visible.  On a machine with a card:
``python -m pytest --noconftest tests/test_torch_cuda_training.py``.
A tiny BERT classifier (2 blocks, hidden 64, 2 heads of 32, seq 32) in
f32 with TF32 off: graph replays against eager steps within 1e-5 relative
on the losses and 1e-5 of max|p| on the weights (the same kernels; the
f32 backward sums dq in a fixed order); a resumed run exactly.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.estimator import Estimator
from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops.attention import (_hash_keep_mask,
                                                  flash_attention)
from analytics_zoo_tpu_torch.ops.dropout import derive_seed
from analytics_zoo_tpu_torch.tfpark import BERTClassifier, TFDataset

pytestmark = pytest.mark.cuda

CFG = dict(vocab=100, hidden_size=64, n_block=2, n_head=2, seq_len=32,
           intermediate_size=128, hidden_drop=0.1, attn_drop=0.1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card run of training")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _keep(seed, B=2, H=3, T=64, D=32, rate=0.1):
    """The forward kernel's keep-mask: with q = 0 all scores tie, so with
    V's row j one-hot(j) output column j is keep[j] * scale / T."""
    q = torch.zeros(B, H, T, D, device="cuda")
    keep = torch.empty(B, H, T, T, dtype=torch.bool, device="cuda")
    idx = torch.arange(D, device="cuda")
    for lo in range(0, T, D):
        v = torch.zeros(B, H, T, D, device="cuda")
        v[:, :, lo + idx, idx] = 1.0
        out = flash_attention(q, q, v, dropout_rate=rate, dropout_seed=seed)
        keep[..., lo:lo + D] = out > 0
    return keep


@pytest.mark.parametrize("seed", [0, 1234, -7, 2**31 - 1])
def test_device_seed_gives_the_int_seeds_mask(dev, seed):
    want = _hash_keep_mask(seed, (2, 3, 64, 64), 0.1, device="cuda")
    assert torch.equal(_keep(seed), want)
    as_tensor = torch.tensor(seed, dtype=torch.int32, device="cuda")
    assert torch.equal(_keep(as_tensor), want)
    derived = derive_seed(as_tensor, torch.tensor(5, device="cuda"))
    assert torch.equal(_keep(derived), _hash_keep_mask(
        derive_seed(seed, 5), (2, 3, 64, 64), 0.1, device="cuda"))


def test_backward_replays_the_device_seeds_mask(dev):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 64, 32, generator=g).cuda()
               .requires_grad_() for _ in range(3))
    go = torch.randn(2, 3, 64, 32, generator=g).cuda()
    seed = torch.tensor(99, dtype=torch.int32, device="cuda")
    grads = []
    for s, backend in ((seed, None), (99, None), (99, "plain")):
        out = flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=s,
                              backend=backend)
        grads.append(torch.autograd.grad(out, (q, k, v), go))
    for a, b in zip(grads[0], grads[1]):
        assert torch.equal(a, b)
    for a, b in zip(grads[0], grads[2]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _dataset(n=64, batch=8, memory_type="DEVICE", seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, CFG["vocab"], (n, CFG["seq_len"])).astype(np.int32)
    x = (ids, np.zeros_like(ids), np.ones_like(ids))
    return TFDataset.from_ndarrays((x, (ids[:, 0] % 2).astype(np.int32)),
                                   batch_size=batch,
                                   memory_type=memory_type)


def _weights():
    net = BERTClassifier(2, bert_config=CFG, device="cpu",
                         generator=torch.Generator().manual_seed(1)).net
    return net.get_weights()[0]


def _run(k, memory_type="DEVICE", epochs=1, ds=None, **kw):
    clf = BERTClassifier(2, bert_config=CFG, steps_per_dispatch=k,
                         optimizer=AdamWeightDecay(lr=1e-3, total=40),
                         device="cuda", **kw).load_weights(_weights())
    _kernels.reset_launches()
    clf.train(ds or _dataset(memory_type=memory_type), epochs=epochs,
              seed=3)
    torch.cuda.synchronize()
    launches = (_kernels.flash_fwd.launches, _kernels.flash_bwd.launches)
    return clf, [h["loss"] for h in clf._train_est.history], launches


@pytest.mark.parametrize("memory_type", ["DEVICE", "DRAM"])
def test_graph_replays_equal_eager_steps(dev, memory_type):
    # 8 steps an epoch, 2 epochs: K = 4 replays a captured step, K = 1
    # runs eager steps; dropout on, so a frozen seed or count would show
    graph, gl, glaunch = _run(4, memory_type, epochs=2)
    eager, el, elaunch = _run(1, memory_type, epochs=2)
    assert graph._train_est._graph is not None
    assert eager._train_est._graph is None
    np.testing.assert_allclose(gl, el, rtol=1e-5)
    for (n, a), (_, b) in zip(graph.net.named_parameters(),
                              eager.net.named_parameters()):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), n
    # launches: 2 per step (one forward, one backward a block), counted
    # through the replays, not at capture
    assert glaunch == elaunch == (2 * 16, 2 * 16)


def test_a_second_device_dataset_is_captured_anew(dev):
    # one classifier trains on two DEVICE-tier datasets of one shape in
    # turn: the second's steps are captured anew and read its batches, so
    # the graph's losses and weights are the eager steps'
    runs = []
    for k in (4, 1):
        clf = BERTClassifier(2, bert_config=CFG, steps_per_dispatch=k,
                             optimizer=AdamWeightDecay(lr=1e-3, total=40),
                             device="cuda").load_weights(_weights())
        for seed in (0, 1):
            clf.train(lambda: _dataset(seed=seed), epochs=1, seed=3)
        torch.cuda.synchronize()
        runs.append((clf, [h["loss"] for h in clf._train_est.history]))
    (graph, gl), (eager, el) = runs
    assert len(gl) == 2 and gl[0] != gl[1]
    np.testing.assert_allclose(gl, el, rtol=1e-5)
    for (n, a), (_, b) in zip(graph.net.named_parameters(),
                              eager.net.named_parameters()):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), n


def test_mixed_precision_graph_runs(dev):
    clf, losses, launches = _run(4, epochs=3, mixed_precision=True,
                                 grad_dtype="bfloat16")
    est = clf._train_est
    assert launches == (2 * 24, 2 * 24) and np.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in clf.net.parameters())
    assert int(est.opt_state["count"]) == est.global_step == 24


def test_checkpoint_restored_into_a_captured_graph(dev, tmp_path):
    # train 2 epochs with checkpoints, then restore the first epoch's
    # checkpoint (copy_ into the tensors the graph reads) and run the
    # second epoch again on the same graph: it replays the same losses
    ds = _dataset()
    clf, losses, _ = _run(4, epochs=2, ds=ds, model_dir=str(tmp_path))
    est = clf._train_est
    graph = est._graph
    meta = est._restore(str(tmp_path / "ckpt-8"))
    assert meta["epoch"] == 1 and est.global_step == 8
    est.history.clear()
    est.model.train()
    try:
        est._train_loop(ds.get_training_data(), 8, 2, 1,
                        est._retry_policy.new_state(), None, None, None,
                        None)
    finally:
        est.model.eval()
    assert est._graph is graph                   # replayed, not recaptured
    assert est.global_step == 16
    assert [h["loss"] for h in est.history] == losses[1:]


def test_resume_equals_the_uninterrupted_run(dev, tmp_path):
    whole, wl, _ = _run(4, epochs=2)
    first, _, _ = _run(4, epochs=1, model_dir=str(tmp_path))
    net = BERTClassifier(2, bert_config=CFG, device="cuda").net
    est = Estimator(net, AdamWeightDecay(lr=1e-3, total=40),
                    "sparse_categorical_crossentropy", steps_per_dispatch=4,
                    checkpoint_dir=str(tmp_path), device="cuda")
    hist = est.train(_dataset().get_training_data(), 8, epochs=2, seed=3,
                     resume=True)
    assert est.global_step == 16
    assert [h["loss"] for h in hist] == wl[1:]
    for (n, a), (_, b) in zip(whole.net.named_parameters(),
                              net.named_parameters()):
        assert torch.equal(a, b), n
