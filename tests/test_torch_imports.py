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
                 "common.config", "common.context", "common.triggers"):
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
], ids=["resolve_device", "InferenceModel", "BERTClassifier",
        "BERTClassifier.train", "Estimator"])
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
