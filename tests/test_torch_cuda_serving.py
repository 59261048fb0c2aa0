"""The pipelined engine and the HTTP frontend on the card, through the
kernels.

Marked ``cuda``: every test skips with a reason where no CUDA device is
visible.  On a machine with a card: ``python -m pytest --noconftest
tests/test_torch_cuda_serving.py``.  A 2-block BERT classifier (head width
64) is served by the pipelined ``ClusterServing`` behind
``ServingFrontend(port=0)``: every answer, JSON and fast-wire, within 1e-4
of the same model with the plain attention on the card (f32, TF32 off),
and exactly ``n_block`` ``flash_fwd`` launches per dispatched forward.  A
2-layer decoder LM (head width 64) streams over HTTP the tokens that the
broker path gives for the same prompts, with ``n_layers`` ``paged_chunk``
launches per prefill chunk and ``n_layers`` ``paged_decode`` launches per
decode step; ``leak_check`` reads zero after.
"""

import http.client
import json

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common.config import (
    LLMServingConfig, ServingConfig)
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.keras.layers.self_attention import (
    set_attention_backend)
from analytics_zoo_tpu_torch.llm import GenerationClient, LLMServing
from analytics_zoo_tpu_torch.models.generation import DecoderLM
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.serving.broker import InMemoryBroker
from analytics_zoo_tpu_torch.serving.client import FastWireHttpClient
from analytics_zoo_tpu_torch.serving.engine import ClusterServing
from analytics_zoo_tpu_torch.serving.http_frontend import ServingFrontend
from analytics_zoo_tpu_torch.tfpark import BERTClassifier

pytestmark = pytest.mark.cuda

BERT = dict(vocab=200, hidden_size=128, n_block=2, n_head=2, seq_len=32,
            intermediate_size=256)
NAMES = ("input_ids", "token_type_ids", "input_mask")
WAIT = 60.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: serving through the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bert_requests(n, seed=0):
    rs = np.random.default_rng(seed)
    T = BERT["seq_len"]
    out = []
    for _ in range(n):
        length = int(rs.integers(4, T + 1))
        ids = rs.integers(1, BERT["vocab"], T).astype(np.int32)
        ids[length:] = 0
        out.append({"input_ids": ids,
                    "token_type_ids": np.zeros(T, np.int32),
                    "input_mask": (np.arange(T) < length).astype(np.int32)})
    return out


def test_bert_over_http_through_flash_fwd(dev):
    clf = BERTClassifier(num_classes=3, bert_config=BERT, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    im = InferenceModel(device="cuda").load_keras(
        clf.net, preprocessor=lambda d: [d[n] for n in NAMES])
    reqs = _bert_requests(16)
    stacked = {n: np.stack([r[n] for r in reqs]) for n in NAMES}
    im.warmup(stacked, [1, 2, 4, 8, 16])
    forwards = [0]
    hook = clf.net.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    serving = ClusterServing(im, ServingConfig(redis_url="memory://"),
                             broker=InMemoryBroker()).start()
    got = []
    try:
        fe = ServingFrontend(serving, port=0).start()
        try:
            _kernels.reset_launches()
            forwards[0] = 0
            conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                              timeout=WAIT)
            with FastWireHttpClient(port=fe.port, timeout=WAIT) as c:
                for i, r in enumerate(reqs):
                    if i % 2:
                        got.append(c.predict(**r))
                        continue
                    conn.request("POST", "/predict", json.dumps(
                        {"inputs": {n: v.tolist() for n, v in r.items()}}),
                        {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    assert resp.status == 200
                    got.append(np.asarray(
                        json.loads(resp.read())["prediction"], np.float32))
            conn.close()
            torch.cuda.synchronize()
            launches, n_forwards = _kernels.flash_fwd.launches, forwards[0]
        finally:
            fe.stop()
    finally:
        serving.stop()
        hook.remove()
    assert n_forwards and launches == BERT["n_block"] * n_forwards
    set_attention_backend(clf.net, "plain")
    try:
        want = im.predict(stacked)
    finally:
        set_attention_backend(clf.net, None)
    np.testing.assert_allclose(np.stack(got), want, atol=1e-4, rtol=0)


def test_llm_streams_over_http_through_the_paged_kernels(dev):
    model = DecoderLM(96, 128, 2, 2, 256, 512, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    calls = {"decode": 0, "prefill_chunk": 0}

    def counted(name):
        inner = getattr(model, name)

        def call(*args):
            calls[name] += 1
            return inner(*args)
        return call

    eng = LLMServing(model, LLMServingConfig(
        num_blocks=128, block_size=16, max_active=4, max_model_len=256,
        prefill_chunk_tokens=32), broker=InMemoryBroker()).start()
    rs = np.random.default_rng(1)
    prompts = [rs.integers(0, 96, int(rs.integers(8, 80))).astype(np.int32)
               for _ in range(4)]
    try:
        cli = GenerationClient(broker=eng.broker)
        broker_path = [cli.generate(f"b{i}", p, 12, timeout=WAIT).tolist()
                       for i, p in enumerate(prompts)]
        fe = ServingFrontend(llm=eng, port=0).start()
        try:
            model.decode = counted("decode")
            model.prefill_chunk = counted("prefill_chunk")
            _kernels.reset_launches()
            with FastWireHttpClient(port=fe.port, timeout=WAIT) as c:
                over_http = [list(c.generate(p, max_new_tokens=12))
                             for p in prompts]
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in _kernels.KERNELS.items()}
        finally:
            fe.stop()
            for name in calls:
                model.__dict__.pop(name, None)
    finally:
        eng.stop()
    for frames, want in zip(over_http, broker_path):
        assert [k for k, _ in frames] == list(range(12))
        assert [t for _, t in frames] == want
    assert calls["decode"] and calls["prefill_chunk"]
    assert launches["paged_decode"] == 2 * calls["decode"]
    assert launches["paged_chunk"] == 2 * calls["prefill_chunk"]
    lk = eng.cache.leak_check()
    assert lk["tables"] == 0 and lk["held_blocks"] == 0, lk
