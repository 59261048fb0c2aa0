"""The port stands alone: no jax, no JAX package, no silent CPU fallback.

Each check runs in a fresh interpreter so that what this test process has
already imported (jax, for the parity tests) cannot hide an import.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_context():
    """The port's context is process-wide, as the JAX package's is: each
    test starts and ends without one."""
    from analytics_zoo_tpu_torch.common.context import reset_context
    reset_context()
    yield
    reset_context()


def _run(code: str, **env) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, **env})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_no_module_of_the_port_imports_jax():
    out = json.loads(_run(
        "import importlib, json, pkgutil, sys\n"
        "import analytics_zoo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'analytics_zoo_tpu.')) "
        "or m == 'analytics_zoo_tpu')\n"
        "print(json.dumps({'modules': names, 'bad': bad}))"))
    assert out["bad"] == []
    for name in ("ops.attention", "ops._kernels", "ops.dropout", "interop",
                 "keras.layers.self_attention", "keras.losses",
                 "keras.metrics", "keras.optimizers",
                 "tfpark.text_estimators", "tfpark.tf_dataset",
                 "estimator.estimator", "data.cursor", "data.featureset",
                 "inference.inference_model", "serving.engine",
                 "serving.codec", "serving.broker", "serving.client",
                 "serving.http_frontend",
                 "common.config", "common.context", "common.triggers",
                 "common.resilience", "ops.paged_attention",
                 "models.generation", "llm.kv_cache", "llm.prefix_cache",
                 "llm.scheduler", "llm.engine", "llm.client", "parallel",
                 "parallel.mesh", "parallel.ring", "keras.engine",
                 "keras.layers.core", "keras.layers.embedding",
                 "models.common", "models.recommendation",
                 "keras.layers.advanced_activations",
                 "keras.layers.normalization", "keras.layers.convolutional",
                 "keras.layers.pooling", "keras.layers.recurrent",
                 "models.textclassification", "models.anomalydetection",
                 "models.imageclassification", "autograd",
                 "estimator.local_estimator", "models.textmatching",
                 "models.seq2seq", "data.tfrecord", "observability",
                 "observability.metrics", "observability.tracing",
                 "observability.exposition", "observability.flight_recorder",
                 "observability.memory", "observability.trace_cli",
                 "testing", "testing.chaos", "data.sharded",
                 "data.transforms", "serving.model_zoo", "serving.tenancy",
                 "common.health", "native", "inference.batching",
                 "common.wal", "serving.durability", "serving.fleet",
                 "parallel.sharding", "parallel.zero", "parallel.moe",
                 "parallel.pipeline", "parallel.distributed", "orca",
                 "orca.ray"):
        assert f"analytics_zoo_tpu_torch.{name}" in out["modules"]


@pytest.mark.parametrize("entry", [
    "from analytics_zoo_tpu_torch.common.context import resolve_device as f;"
    " f()",
    "from analytics_zoo_tpu_torch.inference import InferenceModel as f; f()",
    "from analytics_zoo_tpu_torch.tfpark import BERTClassifier as f; f(2)",
    "from analytics_zoo_tpu_torch.tfpark import BERTClassifier as f\n"
    "    import numpy as np\n"
    "    from analytics_zoo_tpu_torch.tfpark import TFDataset\n"
    "    x = [np.ones((2, 8), np.int32)] * 3\n"
    "    ds = TFDataset.from_ndarrays((tuple(x), np.zeros(2, np.int32)),"
    " batch_size=2)\n"
    "    f(2, bert_config=dict(seq_len=8)).train(ds)",
    "from analytics_zoo_tpu_torch.estimator import Estimator as f\n"
    "    from torch import nn\n"
    "    f(nn.Linear(2, 2))",
    "from analytics_zoo_tpu_torch.models.generation import DecoderLM as f;"
    " f.tiny()",
    "from analytics_zoo_tpu_torch.models.generation import DecoderLM\n"
    "    from analytics_zoo_tpu_torch.llm import LLMServing as f\n"
    "    f(DecoderLM.tiny(device='cpu'))",
    "from analytics_zoo_tpu_torch.llm import PagedKVCache as f;"
    " f(1, 4, 4, 2, 8)",
    "from analytics_zoo_tpu_torch.common.context import init_zoo_context"
    " as f; f()",
    "from analytics_zoo_tpu_torch.models import NeuralCF as f; f(10, 8)",
    "from analytics_zoo_tpu_torch.models import ColumnFeatureInfo, "
    "WideAndDeep as f\n"
    "    f('wide', column_info=ColumnFeatureInfo(wide_base_cols=['a'], "
    "wide_base_dims=[4]))",
    "from analytics_zoo_tpu_torch.keras.engine import Model as f\n"
    "    from analytics_zoo_tpu_torch.keras.layers import Dense, Input\n"
    "    x = Input((3,))\n"
    "    f(x, Dense(2)(x))",
    "from analytics_zoo_tpu_torch.keras.engine import Sequential as f; f()",
    "from analytics_zoo_tpu_torch.models import TextClassifier as f\n"
    "    f(3, sequence_length=8, vocab_size=20, encoder='gru')",
    "from analytics_zoo_tpu_torch.models import SessionRecommender as f;"
    " f(12)",
    "from analytics_zoo_tpu_torch.models import AnomalyDetector as f;"
    " f((6, 1))",
    "from analytics_zoo_tpu_torch.models import ImageClassifier as f; f(4)",
    "from analytics_zoo_tpu_torch.tfpark import BERTNER as f; f(9)",
    "from analytics_zoo_tpu_torch.tfpark import BERTSQuAD as f; f()",
    "from analytics_zoo_tpu_torch.models import KNRM as f\n"
    "    f(4, 6, vocab_size=20, embed_size=8)",
    "from analytics_zoo_tpu_torch.models import Seq2seq as f; f(12)",
    "from analytics_zoo_tpu_torch.common.health import HealthMonitor as f;"
    " f()",
    "from analytics_zoo_tpu_torch.inference import InferenceModel as f;"
    " f(place_on_load=False)",
    "from analytics_zoo_tpu_torch.common.context import get_context as f;"
    " f()",
    "from analytics_zoo_tpu_torch.parallel import init_moe_params as f;"
    " f(None, 8, 16, 2)",
], ids=["resolve_device", "InferenceModel", "BERTClassifier",
        "BERTClassifier.train", "Estimator", "DecoderLM", "LLMServing",
        "PagedKVCache", "init_zoo_context", "NeuralCF", "WideAndDeep",
        "Model", "Sequential", "TextClassifier", "SessionRecommender",
        "AnomalyDetector", "ImageClassifier", "BERTNER", "BERTSQuAD", "KNRM",
        "Seq2seq", "HealthMonitor", "InferenceModel.place_on_load",
        "get_context", "init_moe_params"])
def test_default_device_raises_without_a_card(entry):
    out = _run(
        "from analytics_zoo_tpu_torch.common.context import "
        "NoCudaDeviceError\n"
        "try:\n"
        f"    {entry}\n"
        "    print('ran')\n"
        "except NoCudaDeviceError as e:\n"
        "    print('raised')\n", CUDA_VISIBLE_DEVICES="")
    assert out == "raised"


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
