#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (exit code 1) on failure:

1. build: every CUDA kernel of the port from ``analytics_zoo_tpu_torch/
   ops/csrc``, one ``nvcc`` per source, all started together;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes BERT-base serving gives it (B=32, H=12, T=128, D=64), in f32
   and bf16, for a ragged padding mask with one fully masked row, causal
   attention with Tq < Tk, and dropout 0.1 (the keep-mask compared bit for
   bit); then its time beside the plain version's, beside
   ``scaled_dot_product_attention`` (a yardstick the port never calls) and
   beside its bound on an H100;
3. serve: BERT-base (hidden 768, 12 blocks, 12 heads, seq 128, vocab
   30522) with random weights from a numpy seed, through
   ``InferenceModel.load_keras`` -> ``ClusterServing`` (classic mode,
   in-memory broker) -> ``InputQueue`` / ``OutputQueue``; 64 requests of
   ragged lengths, every answer checked against the same model with the
   plain attention on the card, and the kernel's launch count checked
   (12 per forward).

4. backward: ``flash_bwd`` against the plain backward
   ``_reference_attention_bwd`` on the card at the BERT-base training shape
   (B=32, H=12, T=128, D=64), f32 and bf16: a ragged mask with one fully
   masked row, causal with Tq < Tk and Tq > Tk, dropout 0.1, and a long
   case (Tk=1024, the regime of the JAX package's blockwise backward);
   dq, dk and dv checked, a second run bit-identical, then timed beside
   the plain backward, the backward of ``scaled_dot_product_attention``
   (a yardstick the port never calls) and the bound on an H100;
5. train: BERT-base (dropout 0.1, 2 classes) from random weights of a
   numpy seed, batch 32, through ``TFDataset.from_ndarrays`` ->
   ``BERTClassifier(optimizer=AdamWeightDecay(...))`` -> ``.train``: 12
   ``flash_fwd`` and 12 ``flash_bwd`` launches per step, one step's loss
   and every gradient against the same step with the plain attention, the
   loss falling over 10 steps on a fixed batch in f32 and in mixed
   precision (bf16 kernels), the step time and a profiler breakdown.

It prints one JSON line of kernel numbers, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the port beside it, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                 seq_len=128, intermediate_size=3072)
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and dense
# FLOP/s by operand type (f32 without TF32 runs outside the tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# kernel vs plain: f32 accumulation order; bf16 two output ulps
TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2e-2, 2.0 ** -7)}
# served probabilities, kernel vs plain attention through 12 f32 blocks
SERVE_ATOL = 1e-4
# backward kernel vs plain: f32 relative to the gradient's scale (five
# products, other summation orders); bf16 as the forward plus one more ulp
# (Z and dS round to bf16 before their products)
BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 2.0 ** -6)}
# one training step, kernels vs plain attention, through 12 f32 blocks
TRAIN_LOSS_ATOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3        # of max|g| of each parameter's gradient
BATCH = 32


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3) -> float:
    """Device time per call of ``fn``: the profiler's sum of the kernels
    (and memsets / copies) it ran, over ``iters`` calls; host gaps between
    launches are not counted."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if total_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total_us / iters / 1e3


def phase_build():
    from analytics_zoo_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    paths = _kernels.build()
    secs = time.perf_counter() - t0
    for src, path in paths.items():
        log(f"[build] {src} -> {os.path.relpath(path, ROOT)}")
    log(f"[build] {len(paths)} kernel source(s) in {secs:.2f} s")


def _attention_inputs(dtype, B, H, Tq, Tk, D, gen):
    mk = lambda T: torch.randn(B, H, T, D, generator=gen).to("cuda", dtype)
    return mk(Tq), mk(Tk), mk(Tk)


def _ragged_mask(B, Tk, gen):
    lens = torch.randint(1, Tk + 1, (B,), generator=gen)
    lens[0] = 0                                   # one fully masked row
    return (torch.arange(Tk)[None] < lens[:, None]).to("cuda", torch.int32)


def _extract_keep_mask(flash_attention, B, H, T, D, rate, seed):
    """The kernel's own keep-mask: with q = 0 every score is equal, so
    with V's row j = one-hot(j) output column j is keep[j] * scale / T."""
    q = torch.zeros(B, H, T, D, device="cuda")
    keep = torch.empty(B, H, T, T, dtype=torch.bool, device="cuda")
    idx = torch.arange(D, device="cuda")
    for lo in range(0, T, D):
        v = torch.zeros(B, H, T, D, device="cuda")
        v[:, :, lo + idx, idx] = 1.0
        out = flash_attention(q, q, v, dropout_rate=rate, dropout_seed=seed)
        keep[..., lo:lo + D] = out > 0
    return keep


def phase_kernels():
    from analytics_zoo_tpu_torch.ops.attention import (
        _hash_keep_mask, flash_attention)
    B, H, T, D = 32, 12, 128, 64
    gen = torch.Generator().manual_seed(SEED)
    cases = {
        "ragged padding mask": dict(Tq=T, mask=True),
        "causal Tq=100 < Tk=128": dict(Tq=100, causal=True),
        "dropout 0.1 + mask": dict(Tq=T, mask=True, dropout_rate=0.1,
                                   dropout_seed=1234),
    }
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        for name, case in cases.items():
            case = dict(case)
            Tq = case.pop("Tq")
            q, k, v = _attention_inputs(dtype, B, H, Tq, T, D, gen)
            mask = _ragged_mask(B, T, gen) if case.pop("mask", False) \
                else None
            out = flash_attention(q, k, v, padding_mask=mask, **case)
            ref = flash_attention(q, k, v, padding_mask=mask,
                                  backend="plain", **case)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            bad = (diff > atol + rtol * ref.float().abs()).sum().item()
            log(f"[kernel] flash_fwd {str(dtype)[6:]:8s} {name:24s} "
                f"max_abs_err={err:.3e} tol=atol {atol:g} + rtol {rtol:g}"
                f" -> {'ok' if not bad else f'{bad} elements out'}")
            if bad or not torch.isfinite(out).all():
                raise AssertionError(f"flash_fwd disagrees with its plain "
                                     f"version: {dtype} {name}")
            errs.setdefault(dtype, 0.0)
            errs[dtype] = max(errs[dtype], err)
    keep = _extract_keep_mask(flash_attention, B, H, T, D, 0.1, 1234)
    want = _hash_keep_mask(1234, (B, H, T, T), 0.1, device="cuda")
    if not torch.equal(keep, want):
        raise AssertionError("flash_fwd keep-mask differs from the counter "
                             "hash")
    log(f"[kernel] flash_fwd keep-mask bit-identical to the plain version's "
        f"({keep.numel()} positions, kept {keep.float().mean().item():.4f})")

    # timing at the serving shapes; an all-valid mask, so the work the
    # bound counts is the full T x T per head
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _attention_inputs(dtype, B, H, T, T, D, gen)
        mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
        bool_mask = (mask != 0)[:, None, None, :]
        ms = cuda_ms(lambda: flash_attention(q, k, v, padding_mask=mask))
        plain_ms = cuda_ms(lambda: flash_attention(
            q, k, v, padding_mask=mask, backend="plain"))
        lib_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q, k, v,
                                                       attn_mask=bool_mask))
        nbytes = 4 * B * H * T * D * q.element_size() + mask.numel() * 4
        flops = 4 * B * H * T * T * D
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, \
            flops / PEAK_FLOPS[dtype] * 1e3
        rows[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations", max_abs_err=errs[dtype])
        log(f"[kernel] flash_fwd {str(dtype)[6:]:8s} B{B} H{H} T{T} D{D}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({rows[dtype]['bound_by']}; bytes {t_bytes:.4f} ms, "
            f"operations {t_ops:.4f} ms)")
    return rows


def _random_bert_tree(net, rng):
    """Weights from a numpy seed in the JAX tree layout (std 0.02; LayerNorm
    gains around 1)."""
    tree = {}
    for path, p in net.state_dict().items():
        w = rng.standard_normal(tuple(p.shape), dtype=np.float32) * 0.02
        if path.endswith("gamma"):
            w += 1.0
        node = tree
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = w
    return tree


def _requests(n, rng, cfg):
    T = cfg["seq_len"]
    reqs = {}
    for i in range(n):
        length = int(rng.integers(8, T + 1))
        ids = rng.integers(1, cfg["vocab"], T).astype(np.int32)
        ids[length:] = 0
        reqs[f"req-{i:03d}"] = {
            "input_ids": ids,
            "token_type_ids": (np.arange(T) >= length // 2).astype(np.int32),
            "input_mask": (np.arange(T) < length).astype(np.int32)}
    return reqs


def phase_serve(cfg=BERT_BASE, device="cuda", n_requests=64,
                batch_size=32):
    from analytics_zoo_tpu_torch.common.config import ServingConfig
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        set_attention_backend)
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
    from analytics_zoo_tpu_torch.serving.client import InputQueue, OutputQueue
    from analytics_zoo_tpu_torch.serving.engine import ClusterServing
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    rng = np.random.default_rng(SEED)
    clf = BERTClassifier(num_classes=2, bert_config=cfg, device=device)
    tree = _random_bert_tree(clf.net, rng)
    names = ("input_ids", "token_type_ids", "input_mask")
    im = InferenceModel(device=device).load_keras(
        clf.net, (tree, {}),
        preprocessor=lambda d: [d[n] for n in names])
    log(f"[serve] BERT classifier {cfg}, {clf.net.param_count():,} "
        f"parameters (f32) on {device}")
    reqs = _requests(n_requests, rng, cfg)
    stacked = {n: np.stack([r[n] for r in reqs.values()]) for n in names}
    im.warmup(stacked, [2 ** i for i in range(batch_size.bit_length())])

    forwards = [0]
    hook = clf.net.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    broker = InMemoryBroker()
    serving = ClusterServing(im, ServingConfig(
        pipeline=False, batch_size=batch_size, redis_url="memory://"),
        broker=broker).start()
    iq, oq = InputQueue(broker=broker), OutputQueue(broker=broker)
    sent, done, results = {}, {}, {}
    try:
        _kernels.reset_launches()
        forwards[0] = 0
        t_start = time.perf_counter()
        for uri, data in reqs.items():
            sent[uri] = time.perf_counter()
            iq.enqueue(uri, **data)
        for uri in reqs:
            results[uri] = oq.query_blocking(uri, timeout=300)
            done[uri] = time.perf_counter()
        t_end = time.perf_counter()
        launches = _kernels.flash_fwd.launches
        n_forwards = forwards[0]
    finally:
        serving.stop()
        hook.remove()
    missing = [u for u, r in results.items() if r is None]
    if missing:
        raise AssertionError(f"no result for {missing}")
    lat = np.array([done[u] - sent[u] for u in reqs]) * 1e3
    rps = n_requests / (t_end - t_start)
    log(f"[serve] {n_requests} requests (burst) in {t_end - t_start:.4f} s: "
        f"{rps:.2f} req/s, latency p50 {np.percentile(lat, 50):.3f} ms, "
        f"p99 {np.percentile(lat, 99):.3f} ms, in {n_forwards} forwards")
    log(f"[serve] flash_fwd launches {launches} = "
        f"{launches / max(n_forwards, 1):g} per forward")
    if n_forwards == 0 or launches != cfg["n_block"] * n_forwards:
        raise AssertionError(f"expected {cfg['n_block']} flash_fwd "
                             f"launches per forward, got {launches} in "
                             f"{n_forwards} forwards")

    # every answer against the same model with the plain attention
    served = np.stack([np.asarray(results[u]).ravel() for u in reqs])
    set_attention_backend(clf.net, "plain")
    try:
        want = np.concatenate([
            im.predict({n: v[s:s + batch_size] for n, v in stacked.items()})
            for s in range(0, n_requests, batch_size)])
    finally:
        set_attention_backend(clf.net, None)
    err = float(np.abs(served - want).max())
    ok = (served.shape == (n_requests, 2) and np.isfinite(served).all()
          and np.allclose(served.sum(-1), 1.0, atol=1e-5)
          and err <= SERVE_ATOL)
    log(f"[serve] served probabilities vs plain attention on the card: "
        f"max_abs_err={err:.3e} tol={SERVE_ATOL:g} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("served results disagree with the plain path")

    x = {n: v[:batch_size] for n, v in stacked.items()}
    fwd_ms = cuda_ms(lambda: im.predict(x), iters=10, warmup=2)
    set_attention_backend(clf.net, "plain")
    try:
        plain_fwd_ms = cuda_ms(lambda: im.predict(x), iters=10, warmup=2)
    finally:
        set_attention_backend(clf.net, None)
    log(f"[serve] InferenceModel.predict at batch {batch_size}: "
        f"{fwd_ms:.3f} ms with the kernel, {plain_fwd_ms:.3f} ms with the "
        f"plain attention")
    profile_breakdown(lambda: im.predict(x), f"predict at batch {batch_size}")
    return launches


def _bwd_inputs(dtype, B, H, Tq, Tk, D, gen, mask=False):
    q, k, v = _attention_inputs(dtype, B, H, Tq, Tk, D, gen)
    go = torch.randn(B, H, Tq, D, generator=gen).to("cuda", dtype)
    return q, k, v, go, (_ragged_mask(B, Tk, gen) if mask else None)


def phase_backward():
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.ops.attention import (
        _reference_attention_bwd, flash_attention)
    B, H, T, D = 32, 12, 128, 64
    gen = torch.Generator().manual_seed(SEED + 1)
    cases = {
        "ragged padding mask": dict(Tq=T, Tk=T, mask=True),
        "causal Tq=100 < Tk=128": dict(Tq=100, Tk=T, causal=True),
        "causal Tq=128 > Tk=100": dict(Tq=T, Tk=100, causal=True),
        "dropout 0.1 + mask": dict(Tq=T, Tk=T, mask=True, dropout_rate=0.1,
                                   dropout_seed=4321),
        "long Tk=1024 + mask": dict(Tq=T, Tk=1024, mask=True),
    }
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = BWD_TOL[dtype]
        for name, case in cases.items():
            case = dict(case)
            q, k, v, go, mask = _bwd_inputs(dtype, B, H, case.pop("Tq"),
                                            case.pop("Tk"), D, gen,
                                            case.pop("mask", False))
            o = flash_attention(q, k, v, padding_mask=mask, **case)
            kw = dict(causal=case.get("causal", False), sm_scale=D ** -0.5,
                      dropout_p=case.get("dropout_rate", 0.0),
                      seed=case.get("dropout_seed"))
            got = _kernel_bwd(_kernels, q, k, v, o, go, mask, **kw)
            again = _kernel_bwd(_kernels, q, k, v, o, go, mask, **kw)
            ref = _reference_attention_bwd(
                q, k, v, o, go, mask, kw["causal"], kw["sm_scale"],
                kw["dropout_p"], kw["seed"])
            torch.cuda.synchronize()
            worst = 0.0
            for gname, a, b, c in zip(("dq", "dk", "dv"), got, ref, again):
                scale = max(1.0, b.float().abs().max().item()) \
                    if dtype == torch.float32 else 1.0
                diff = (a.float() - b.float()).abs()
                bad = (diff > atol * scale + rtol * b.float().abs()).sum()
                if (bad.item() or not torch.isfinite(a).all()
                        or not torch.equal(a, c)):
                    raise AssertionError(
                        f"flash_bwd {dtype} {name} {gname}: {bad.item()} "
                        f"elements out of tolerance, max_abs_err "
                        f"{diff.max().item():.3e}, repeat identical "
                        f"{torch.equal(a, c)}")
                worst = max(worst, diff.max().item())
            log(f"[backward] flash_bwd {str(dtype)[6:]:8s} {name:24s} "
                f"max_abs_err={worst:.3e} (dq, dk, dv) tol=atol {atol:g}"
                f"{' x max(1, max|ref|)' if dtype == torch.float32 else ''}"
                f" + rtol {rtol:g}; repeat bit-identical -> ok")
            errs[dtype] = max(errs.get(dtype, 0.0), worst)

    # timing at the training shape, all-valid mask: the bound counts the
    # full T x T per head
    rows = {}
    F = torch.nn.functional
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, go, _ = _bwd_inputs(dtype, B, H, T, T, D, gen)
        mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
        bool_mask = (mask != 0)[:, None, None, :]
        o = flash_attention(q, k, v, padding_mask=mask)
        kw = dict(causal=False, sm_scale=D ** -0.5, dropout_p=0.0, seed=None)
        kernel = lambda: _kernel_bwd(_kernels, q, k, v, o, go, mask, **kw)
        plain = lambda: _reference_attention_bwd(q, k, v, o, go, mask,
                                                 False, D ** -0.5)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(*leaves,
                                                      attn_mask=bool_mask)
        sdpa_fwd_bwd = lambda: torch.autograd.grad(sdpa(), leaves, go)
        ms = cuda_ms(kernel)
        # the plain backward and SDPA's run many small launches under
        # autograd, whose host time CUDA events would count: their
        # columns are device time from the profiler (the kernel's too, to
        # show the two clocks agree on it)
        kernel_dev = device_ms(kernel)
        plain_ms = device_ms(plain)
        fwd_bwd_ms, fwd_ms = device_ms(sdpa_fwd_bwd), device_ms(sdpa)
        nbytes = 8 * B * H * T * D * q.element_size() + mask.numel() * 4
        flops = 10 * B * H * T * T * D
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        rows[dtype] = dict(ms=ms, plain_ms=plain_ms,
                           library_ms=fwd_bwd_ms - fwd_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations", max_abs_err=errs[dtype],
                           device_ms=kernel_dev)
        log(f"[backward] flash_bwd {str(dtype)[6:]:8s} B{B} H{H} T{T} D{D}: "
            f"kernel {ms:.4f} ms (device {kernel_dev:.4f} ms), plain "
            f"{plain_ms:.4f} ms (device), sdpa backward "
            f"{fwd_bwd_ms - fwd_ms:.4f} ms (device: forward+backward "
            f"{fwd_bwd_ms:.4f} - forward {fwd_ms:.4f}), bound "
            f"{max(t_bytes, t_ops):.4f} ms ({rows[dtype]['bound_by']}; "
            f"bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms)")
    return rows


def _kernel_bwd(kernels, q, k, v, o, go, mask, causal, sm_scale, dropout_p,
                seed):
    """One direct call of the backward kernel's wrapper."""
    from analytics_zoo_tpu_torch.ops.attention import _drop_args
    return kernels.flash_bwd(q, k, v, o, go, mask, causal=causal,
                             sm_scale=sm_scale,
                             **_drop_args(dropout_p, seed))


def _train_batches(n_batches, rng, cfg):
    """``n_batches * BATCH`` BERT inputs with learnable labels (the first
    token's parity, as ``bench.py`` makes them), as a TFDataset."""
    from analytics_zoo_tpu_torch.tfpark import TFDataset
    n, T = n_batches * BATCH, cfg["seq_len"]
    ids = rng.integers(0, cfg["vocab"], (n, T)).astype(np.int32)
    lens = rng.integers(T // 2, T + 1, n)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    seg = (np.arange(T)[None] >= (lens // 2)[:, None]).astype(np.int32)
    labels = (ids[:, 0] % 2).astype(np.int32)
    return TFDataset.from_ndarrays(((ids * mask, seg, mask), labels),
                                   batch_size=BATCH)


def _classifier(cfg, tree, mixed_precision=False):
    from analytics_zoo_tpu_torch.keras.optimizers import AdamWeightDecay
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    clf = BERTClassifier(
        num_classes=2, bert_config=cfg, mixed_precision=mixed_precision,
        optimizer=AdamWeightDecay(lr=1e-4, warmup_portion=0.1, total=10),
        device="cuda")
    return clf.load_weights(tree)


def _step_loss_and_grads(clf, x, y, seed):
    """One training forward and backward (no update): loss, gradients."""
    from analytics_zoo_tpu_torch.keras import losses
    net = clf.net
    net.train()
    try:
        loss = losses.get("sparse_categorical_crossentropy")(
            net(x, seed=seed), y)
        params = [p for _, p in net.named_parameters()]
        grads = torch.autograd.grad(loss, params)
    finally:
        net.eval()
    return loss.item(), dict(zip([n for n, _ in net.named_parameters()],
                                 grads))


def _train_run(clf, ds, steps, what):
    """``steps`` steps of ``clf.train`` on ``ds`` (one batch an epoch),
    launches counted from zero around it; returns (losses, launches)."""
    from analytics_zoo_tpu_torch.ops import _kernels
    _kernels.reset_launches()
    clf.train(ds, epochs=steps, seed=SEED)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
    losses = [h["loss"] for h in clf._train_est.history[-steps:]]
    log(f"[train] {what}: per-step loss "
        f"{' '.join(f'{v:.4f}' for v in losses)}; launches {launches}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: the loss did not fall over {steps} "
                             f"steps on a fixed batch: {losses}")
    return losses, launches


def phase_train(cfg=None, steps=10):
    from analytics_zoo_tpu_torch.keras.layers.self_attention import (
        set_attention_backend)
    from analytics_zoo_tpu_torch.ops import _kernels
    cfg = cfg or dict(BERT_BASE, hidden_drop=0.1, attn_drop=0.1)
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    rng = np.random.default_rng(SEED)
    tree = _random_bert_tree(BERTClassifier(2, bert_config=cfg,
                                            device="cpu").net, rng)
    fixed = _train_batches(1, rng, cfg)
    many = _train_batches(8, rng, cfg)
    n_block = cfg["n_block"]
    log(f"[train] BERT classifier {cfg}, batch {BATCH}, AdamWeightDecay"
        f"(lr=1e-4, warmup 1 of 10 steps), dropout seed {SEED}")

    # 1. launches of one step through the user's entry point
    clf = _classifier(cfg, tree)
    _kernels.reset_launches()
    clf.train(fixed, epochs=1, seed=SEED)
    torch.cuda.synchronize()
    one = (_kernels.flash_fwd.launches, _kernels.flash_bwd.launches)
    log(f"[train] one step: flash_fwd {one[0]}, flash_bwd {one[1]} launches")
    if one != (n_block, n_block):
        raise AssertionError(f"expected {n_block} + {n_block} launches per "
                             f"step, got {one}")

    # 2. one step with the kernels against one with the plain attention,
    # same weights, batch and dropout seed
    x, y = next(iter(fixed.get_training_data().batches(BATCH,
                                                       device="cuda")))
    clf = _classifier(cfg, tree)
    loss_k, grads_k = _step_loss_and_grads(clf, x, y, seed=7)
    set_attention_backend(clf.net, "plain")
    loss_p, grads_p = _step_loss_and_grads(clf, x, y, seed=7)
    set_attention_backend(clf.net, None)
    worst, worst_name = 0.0, ""
    for name, gk in grads_k.items():
        gp = grads_p[name]
        rel = ((gk - gp).abs().max() / gp.abs().max().clamp_min(1e-30)
               ).item()
        if rel > worst:
            worst, worst_name = rel, name
    log(f"[train] kernels vs plain attention, one step: loss {loss_k:.7f} vs "
        f"{loss_p:.7f} (|d| {abs(loss_k - loss_p):.2e}, tol "
        f"{TRAIN_LOSS_ATOL:g}); worst gradient |d|/max|g| {worst:.2e} at "
        f"{worst_name} (tol {TRAIN_GRAD_RTOL:g}) over {len(grads_k)} tensors")
    if abs(loss_k - loss_p) > TRAIN_LOSS_ATOL or worst > TRAIN_GRAD_RTOL:
        raise AssertionError("a training step with the kernels disagrees "
                             "with the plain attention")
    del grads_k, grads_p

    # 3. and 4. the loss falls over 10 steps on a fixed batch, f32 and
    # mixed precision; the f32 run is the main path whose launches count
    runs = {}
    for mixed in (False, True):
        what = "mixed precision (bf16)" if mixed else "f32"
        clf = _classifier(cfg, tree, mixed_precision=mixed)
        losses, launches = _train_run(clf, fixed, steps, what)
        if launches != {"flash_fwd": steps * n_block,
                        "flash_bwd": steps * n_block}:
            raise AssertionError(f"{what}: expected {steps * n_block} "
                                 f"launches of each kernel, got {launches}")
        runs[what] = dict(losses=losses, launches=launches)

    # 5. step time over 8 distinct batches (one host read at the end),
    # after a warm-up epoch, and a device breakdown of one step, in f32
    # and in mixed precision
    step_ms = {}
    for mixed in (False, True):
        what = "mixed precision (bf16)" if mixed else "f32"
        clf = _classifier(cfg, tree, mixed_precision=mixed)
        clf.train(many, epochs=1, seed=SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf.train(many, epochs=1, seed=SEED + 1)
        torch.cuda.synchronize()
        step_ms[what] = (time.perf_counter() - t0) * 1e3 / 8
        log(f"[train] {what} step at batch {BATCH}: {step_ms[what]:.3f} ms "
            f"({BATCH * 1e3 / step_ms[what]:.2f} samples/s) over 8 steps")
        profile_breakdown(lambda: clf.train(fixed, epochs=1, seed=SEED),
                          f"one {what} training step at batch {BATCH}",
                          top=16)
    return runs["f32"]["launches"], dict(step_ms=step_ms, runs=runs)


def profile_breakdown(fn, what, top=8):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(t for _, t, _ in dev)
    if total <= 0:
        log(f"[profile] {what}: the profiler recorded no device time "
            "(device breakdown not measured)")
        return
    log(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{total / 1e3:.3f} ms ({100 * total / wall_us:.1f}% of wall)")
    for key, t, n in sorted(dev, key=lambda r: -r[1])[:top]:
        log(f"[profile]   {100 * t / total:5.1f}%  {t / 1e3:8.3f} ms  "
            f"x{n:<4d} {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import analytics_zoo_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    phase_build()
    rows = phase_kernels()
    serve_launches = phase_serve()
    bwd_rows = phase_backward()
    train_launches, _ = phase_train()

    def entry(name, source, replaces, rows, launches, **extra):
        f32 = rows[torch.float32]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
                "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
                "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
                "shape": "B32 H12 T128 D64 float32",
                "bf16": dict(rows[torch.bfloat16]), **extra}

    kernels = [
        entry("flash_fwd", "analytics_zoo_tpu_torch/ops/csrc/flash_fwd.cu",
              "analytics_zoo_tpu/ops/attention.py:169", rows,
              train_launches["flash_fwd"],
              launches_in="10 f32 training steps",
              serve_launches=serve_launches),
        entry("flash_bwd", "analytics_zoo_tpu_torch/ops/csrc/flash_bwd.cu",
              "analytics_zoo_tpu/ops/attention.py:407", bwd_rows,
              train_launches["flash_bwd"],
              launches_in="10 f32 training steps",
              library="backward of scaled_dot_product_attention"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
