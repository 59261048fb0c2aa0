"""The port's config surface against the JAX package's, on the CPU.

``load_config`` in both packages reads the same JSON and simple-YAML files
(inline comments, quoted values, coercion, ``224x224`` tuples), the same
``ZOO_TPU_*`` environment and the same ``**overrides`` with ``__`` paths,
in the same precedence (defaults < file < env < overrides), and must give
field-by-field equal trees; a missing file and a bad value raise the same
exception types, and a key that names no field is ignored by both.  What
the port still refuses (multi-process fields, unported training fields)
raises ``NotImplementedError`` naming its ROADMAP item.
``init_zoo_context(config_path=...)`` builds its context from the file.
"""

import dataclasses
import json
import os

import pytest

from analytics_zoo_tpu.common import config as jcfg
from analytics_zoo_tpu_torch.common import config as tcfg
from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                    reset_context)


@pytest.fixture(autouse=True)
def _fresh_port_context():
    """The port's context is process-wide, as the JAX package's is: each
    test starts and ends without one."""
    from analytics_zoo_tpu_torch.common.context import reset_context
    reset_context()
    yield
    reset_context()

YAML = """\
# serving config.yaml, as the reference ships it
serving:
  redis_url: memory://   # the in-memory broker
  batch_size: 16
  max_batch: 64
  linger_ms: 2.5
  filter: "topN(3)"
  http_host: '0.0.0.0 # not a comment'
  image_resize: 224x224
  pipeline: false
train:
  gradient_clip_norm: 1.5
mesh:
  axis_names: data,model
platform: cpu
default_dtype: bfloat16
"""


@pytest.fixture(autouse=True)
def _no_zoo_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("ZOO_TPU_"):
            monkeypatch.delenv(k)


def _tree(cfg):
    return dataclasses.asdict(cfg)


def _both(path=None, **overrides):
    return (_tree(tcfg.load_config(path, **overrides)),
            _tree(jcfg.load_config(path, **overrides)))


@pytest.mark.parametrize("section", ["MeshConfig", "TrainConfig",
                                     "DataConfig", "ServingConfig",
                                     "FleetConfig", "LLMServingConfig",
                                     "ZooConfig"])
def test_sections_have_the_jax_fields_and_defaults(section):
    def fields(cls):
        return [(f.name, f.default, f.default_factory is dataclasses.MISSING)
                for f in dataclasses.fields(cls)]
    assert fields(getattr(tcfg, section)) == fields(getattr(jcfg, section))


def test_defaults_equal():
    got, want = _both()
    assert got == want


def test_yaml_file_equals_jax(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(YAML)
    got, want = _both(str(path))
    assert got == want
    assert got["serving"]["http_host"] == "0.0.0.0 # not a comment"
    assert got["serving"]["image_resize"] == (224, 224)
    assert got["serving"]["linger_ms"] == 2.5
    assert got["serving"]["pipeline"] is False
    assert got["mesh"]["axis_names"] == ("data", "model")


def test_json_file_equals_jax(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "serving": {"batch_size": 8, "admission_max_inflight": 32,
                    "http_coalesce": False},
        "fleet": {"replicas": 3},
        "data": {"prefetch": 4, "memory_type": "PMEM"},
        "compute_dtype": "float32"}))
    got, want = _both(str(path))
    assert got == want
    assert got["fleet"]["replicas"] == 3 and got["data"]["prefetch"] == 4


def test_env_and_overrides_in_precedence(tmp_path, monkeypatch):
    path = tmp_path / "config.yaml"
    path.write_text("serving:\n  batch_size: 16\n  max_batch: 64\n"
                    "  linger_ms: 3\n")
    monkeypatch.setenv("ZOO_TPU_SERVING__MAX_BATCH", "128")
    monkeypatch.setenv("ZOO_TPU_SERVING__LINGER_MS", "4.5")
    monkeypatch.setenv("ZOO_TPU_SERVING__HTTP_COALESCE", "no")
    monkeypatch.setenv("ZOO_TPU_PLATFORM", "cpu")
    got, want = _both(str(path), serving__linger_ms=7.0,
                      train__gradient_clip_value="0.5")
    assert got == want
    s = got["serving"]
    # file < env < overrides
    assert (s["batch_size"], s["max_batch"], s["linger_ms"]) == (16, 128,
                                                                 7.0)
    assert s["http_coalesce"] is False and got["platform"] == "cpu"
    assert got["train"]["gradient_clip_value"] == 0.5


def test_same_errors_and_unknown_keys_ignored(tmp_path):
    for load in (tcfg.load_config, jcfg.load_config):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "missing.yaml"))
        with pytest.raises(ValueError):
            load(None, serving__batch_size="many")
    path = tmp_path / "config.yaml"
    path.write_text("serving:\n  no_such_field: 3\nbogus: 1\n")
    got, want = _both(str(path), nothing__here=2)
    assert got == want == _tree(tcfg.ZooConfig())


@pytest.mark.parametrize("override,item", [
    (dict(num_processes="2"), 5), (dict(coordinator_address="h:1234"), 5),
    (dict(process_id="1"), 5), (dict(train__rng_impl="threefry"), 2)])
def test_unported_values_raise_naming_their_item(override, item):
    name = next(iter(override)).split("__")[-1]
    with pytest.raises(NotImplementedError,
                       match=f"{name}=.*Queue 1 item {item}"):
        tcfg.load_config(None, **override)
    jcfg.load_config(None, **override)          # the JAX package takes it


def test_ported_train_values_are_taken():
    # checkpoint retention, retries and the dispatch cap are ported now
    cfg = tcfg.load_config(None, train__keep_checkpoints="1",
                           train__failure_retry_times="2",
                           train__max_steps_per_dispatch="64")
    want = jcfg.load_config(None, train__keep_checkpoints="1",
                            train__failure_retry_times="2",
                            train__max_steps_per_dispatch="64")
    assert (cfg.train.keep_checkpoints, cfg.train.failure_retry_times,
            cfg.train.max_steps_per_dispatch) == (
        want.train.keep_checkpoints, want.train.failure_retry_times,
        want.train.max_steps_per_dispatch) == (1, 2, 64)


def test_one_process_values_are_taken():
    cfg = tcfg.load_config(None, num_processes="1", process_id="0")
    assert (cfg.num_processes, cfg.process_id) == (1, 0)


def test_replace_returns_a_new_tree():
    cfg = tcfg.ZooConfig()
    other = cfg.replace(platform="cpu")
    assert other.platform == "cpu" and cfg.platform is None
    assert other.serving is cfg.serving


def test_init_zoo_context_reads_the_config_file(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(YAML)
    ctx = init_zoo_context(config_path=str(path))
    assert _tree(ctx.config) == _tree(jcfg.load_config(str(path)))
    assert ctx.num_devices == 1 and ctx.mesh.devices.flat[0].type == "cpu"
    assert init_zoo_context(compute_dtype="float32") is ctx   # idempotent
    reset_context()
    ctx = init_zoo_context(config_path=str(path), compute_dtype="float32",
                           mesh__data="1")
    assert ctx.config.compute_dtype == "float32"
    assert ctx.config.serving.batch_size == 16


def test_init_zoo_context_platform(monkeypatch):
    monkeypatch.setenv("ZOO_TPU_PLATFORM", "cpu")
    assert init_zoo_context().mesh.devices.flat[0].type == "cpu"
    reset_context()
    with pytest.raises(ValueError, match="platform 'tpu'"):
        init_zoo_context(platform="tpu")
    # a conf wins over the file and the environment, as in the JAX package
    ctx = init_zoo_context(tcfg.ZooConfig(platform="cpu"),
                           config_path="/no/such/file")
    assert ctx.config.platform == "cpu"
