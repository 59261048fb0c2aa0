"""The port's sharding rules, ZeRO specs and placement against the JAX
package's, on the CPU.

``partition_specs`` / ``partition_params`` and ``zero_partition_spec`` /
``zero_shardings`` (with ``base_specs``) must give the JAX package's specs,
compared as tuples leaf by leaf, on a tiny BERT tree: the JAX tree itself
(as numpy arrays), and the port BERT's ``state_dict``, whose dotted keys
are the JAX paths.  Dimensions that do not divide the axis replicate.
``bytes_per_device`` of trees placed by ``device_put`` equals the JAX
package's of the same trees placed by ``jax.device_put``.  Both sides use
the 8-device CPU mesh layout (the port's over ``["cpu"] * 8``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding as JNS
from jax.sharding import PartitionSpec as JP

from analytics_zoo_tpu.keras import engine as jengine
from analytics_zoo_tpu.keras.layers import BERT as JBERT
from analytics_zoo_tpu.parallel import sharding as jsharding
from analytics_zoo_tpu.parallel import zero as jzero
from analytics_zoo_tpu_torch.keras import engine as tengine
from analytics_zoo_tpu_torch.keras.layers import BERT as TBERT
from analytics_zoo_tpu_torch.parallel import (
    Mesh, NamedSharding, PartitionSpec as P, ShardedTensor, ShardingRule,
    bytes_per_device, device_put, partition_params, partition_specs,
    replicated_shardings, tree_bytes, zero_partition_spec, zero_shardings)
from analytics_zoo_tpu_torch.parallel.mesh import tree_map_with_path
from analytics_zoo_tpu_torch.parallel.sharding import named_shardings

BERT_CFG = dict(vocab=64, hidden_size=16, n_block=1, n_head=2, seq_len=8,
                intermediate_size=32)


def _meshes(data, model):
    jm = JMesh(np.asarray(jax.devices("cpu")[:8]).reshape(data, model),
               ("data", "model"))
    return jm, Mesh(np.full((data, model), "cpu", dtype=object),
                    ("data", "model"))


def _jax_tree():
    jengine.reset_uids()
    params, _ = JBERT(**BERT_CFG).build(jax.random.PRNGKey(0), None)
    return jax.tree_util.tree_map(np.asarray, params)


def _flat_jax(tree):
    """{'/'-joined path: leaf} of a JAX tree of specs or shardings."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, JNS)))[0]
    return {jsharding._path_str(p): v for p, v in flat}


def _flat_port(tree):
    out = {}
    tree_map_with_path(lambda p, v: out.__setitem__(p, v), tree)
    return out


def _specs(flat):
    return {k: tuple(getattr(v, "spec", v)) for k, v in flat.items()}


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4), (8, 1)])
def test_partition_specs_match_jax_on_a_bert_tree(data, model):
    jm, mesh = _meshes(data, model)
    tree = _jax_tree()
    want = _specs(_flat_jax(jsharding.partition_specs(tree, jm)))
    got = _specs(_flat_port(partition_specs(tree, mesh)))
    assert got == want
    if model > 1:
        assert got["token_embed"] == ("model", None)
        assert got["bert_1_block0/attn/qkv/W"] == (None, "model")
        assert got["bert_1_block0/ln1/gamma"] == ()
    # the port model's state_dict: its dotted keys are the JAX paths
    tengine.reset_uids()
    state = TBERT(**BERT_CFG).state_dict()
    got_sd = {k.replace(".", "/"): tuple(v) for k, v in
              partition_specs(state, mesh).items()}
    assert got_sd == want
    # partition_params wraps the same specs in shardings of the mesh
    shardings = _flat_port(partition_params(tree, mesh))
    assert _specs(shardings) == want
    assert all(s.mesh is mesh for s in shardings.values())


def test_odd_dims_replicate_and_rules_take_the_first_match():
    jm, mesh = _meshes(4, 2)
    tree = {"embed_x": {"embeddings": np.zeros((7, 4), np.float32)},
            "ffn": {"fc1": {"W": np.zeros((4, 6), np.float32),
                            "b": np.zeros((5,), np.float32)}},
            "scalar": np.float32(1.0)}
    rules = (ShardingRule(r"fc1/b$", ("model",)),
             ShardingRule(r"fc1", (None, "model")))
    jrules = (jsharding.ShardingRule(r"fc1/b$", ("model",)),
              jsharding.ShardingRule(r"fc1", (None, "model")))
    for r, jr in ((None, None), (rules, jrules)):
        kw = {} if r is None else {"rules": r}
        jkw = {} if jr is None else {"rules": jr}
        got = _specs(_flat_port(partition_specs(tree, mesh, **kw)))
        want = _specs(_flat_jax(jsharding.partition_specs(tree, jm,
                                                          **jkw)))
        assert got == want
    assert got["embed_x/embeddings"] == ()         # 7 % 2: replicated
    assert got["ffn/fc1/b"] == ()                  # first match: 5 % 2
    assert ShardingRule("a/b$", ("model",)).matches("x/a/b")


@pytest.mark.parametrize("shape,dp,base", [
    ((8, 6), 4, None), ((3, 8), 4, None), ((3, 5), 4, None), ((), 4, None),
    ((16, 48), 4, ("model", None)), ((16, 48), 4, (None, "model")),
    ((4, 8), 4, (None, "model")), ((8,), 1, None), ((8, 4), 1, ("model",)),
    ((2, 8), 4, None)])
def test_zero_partition_spec_matches_jax(shape, dp, base):
    got = zero_partition_spec(shape, dp, base=None if base is None
                              else P(*base))
    want = jzero.zero_partition_spec(shape, dp, base=None if base is None
                                     else JP(*base))
    assert isinstance(got, P) and tuple(got) == tuple(want)


@pytest.mark.parametrize("data,model", [(4, 2), (8, 1)])
def test_zero_shardings_with_base_specs_match_jax(data, model):
    jm, mesh = _meshes(data, model)
    tree = _jax_tree()
    want = _specs(_flat_jax(jzero.zero_shardings(
        tree, jm, base_specs=jsharding.partition_specs(tree, jm))))
    got = _specs(_flat_port(zero_shardings(
        tree, mesh, base_specs=partition_specs(tree, mesh))))
    assert got == want
    assert _specs(_flat_port(zero_shardings(tree, mesh))) == _specs(
        _flat_jax(jzero.zero_shardings(tree, jm)))
    assert set(_specs(_flat_port(replicated_shardings(tree, mesh)))
               .values()) == {()}


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4)])
def test_bytes_per_device_of_placed_trees_matches_jax(data, model):
    jm, mesh = _meshes(data, model)
    tree = _jax_tree()
    specs = partition_specs(tree, mesh)
    jspecs = jsharding.partition_specs(tree, jm)
    zspecs = zero_shardings(tree, mesh, base_specs=specs)
    jzspecs = jzero.zero_shardings(tree, jm, base_specs=jspecs)
    for sh, jsh in ((named_shardings(mesh, specs),
                     jsharding.named_shardings(jm, jspecs)),
                    (zspecs, jzspecs)):
        placed = device_put(tree, sh)
        jplaced = jax.device_put(tree, jsh)
        assert bytes_per_device(placed) == jzero.bytes_per_device(jplaced)
        assert tree_bytes(placed) == jzero.tree_bytes(jplaced)
        # every placed leaf gathers back to the tree it came from
        for path, leaf in _flat_port(placed).items():
            assert isinstance(leaf, ShardedTensor)
            np.testing.assert_array_equal(leaf.gather().numpy(),
                                          _flat_port(tree)[path])
    assert bytes_per_device(tree) == tree_bytes(tree) == jzero.tree_bytes(
        tree)
    torch_tree = {"w": torch.zeros(4, 8, dtype=torch.bfloat16)}
    assert tree_bytes(torch_tree) == bytes_per_device(torch_tree) == 64
    split = device_put(torch_tree, {"w": NamedSharding(mesh,
                                                       P(None, "model"))})
    assert bytes_per_device(split) == 64 // model


def test_placement_blocks_follow_the_mesh_coordinates():
    mesh = Mesh(np.full((2, 2), "cpu", dtype=object), ("data", "model"))
    x = torch.arange(48.).reshape(4, 3, 4)
    placed = device_put(x, NamedSharding(mesh, P("data", None, "model")))
    assert placed.shape == x.shape and len(placed.unique_shards()) == 4
    for d in range(2):
        for m in range(2):
            shard = placed.shard({"data": d, "model": m})
            assert shard.is_contiguous()
            assert torch.equal(shard, x[2 * d:2 * d + 2, :, 2 * m:2 * m + 2])
    both = device_put(x, NamedSharding(mesh, P(("data", "model"))))
    assert [tuple(s.shape) for s in both.shards] == [(1, 3, 4)] * 4
    assert torch.equal(both.shard({"data": 1, "model": 0}), x[2:3])
    with pytest.raises(ValueError, match="dimension 0 is split"):
        both[0]
    layer = device_put(x, NamedSharding(mesh, P(None, None, "model")))[1]
    assert torch.equal(layer.gather(), x[1])
    with pytest.raises(ValueError, match="does not divide"):
        NamedSharding(mesh, P("model")).shard_shape((3,))
    with pytest.raises(ValueError, match="no mesh axis"):
        NamedSharding(mesh, P("expert"))
