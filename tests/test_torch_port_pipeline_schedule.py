"""The port's pipeline tick tables and stage splits held against the JAX
package's, element by element.

* `build_1f1b_schedule` and `build_interleaved_schedule`: every table
  (work, microbatch, chunk, receive tables), the tick count and both
  ring depths, on the grid S in {1, 2, 3, 4, 8}, M in {1, 2, 4, 8},
  V in {1, 2, 3} where the schedule is valid; every invalid point raises
  the JAX builder's error type and message.
* `split_points`, `assemble_stages` (the per-stage parameter and state
  trees' keys and shapes, conv weights in the JAX layout),
  `partition_tree`, `unpartition_tree`, the chunk placement helpers, and
  every family's `partition_pytree` (tinycnn, MobileNetV2 with and
  without BN, ResNet-18 and -50, the GPT's stages) on whole-model trees.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

import distributed_model_parallel_tpu.models.gpt as j_gpt
import distributed_model_parallel_tpu.models.mobilenetv2 as j_mobilenetv2
import distributed_model_parallel_tpu.models.staging as j_staging
import distributed_model_parallel_tpu.models.tinycnn as j_tinycnn
import distributed_model_parallel_tpu.parallel.pipeline as j_pipeline
from distributed_model_parallel_tpu_torch.models import gpt, mobilenetv2
from distributed_model_parallel_tpu_torch.models import resnet, staging
from distributed_model_parallel_tpu_torch.models import tinycnn
from distributed_model_parallel_tpu_torch.models.convert import params_spec
from distributed_model_parallel_tpu_torch.parallel import pipeline

# The JAX package's models/__init__ exports a `resnet` function that
# shadows the module.
j_resnet = importlib.import_module(
    "distributed_model_parallel_tpu.models.resnet")

GRID = [(s, m, v) for s in (1, 2, 3, 4, 8) for m in (1, 2, 4, 8)
        for v in (1, 2, 3)]


def _valid(s, m, v):
    return v == 1 or (s >= 2 and m % s == 0)


def _assert_tables_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for field, a, b in zip(want._fields, got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        else:
            assert a == b, field


@pytest.mark.parametrize("S,M", [(s, m) for s in (1, 2, 3, 4, 8)
                                 for m in (1, 2, 4, 8)])
def test_1f1b_tables_equal_jax(S, M):
    _assert_tables_equal(pipeline.build_1f1b_schedule(S, M),
                         j_pipeline.build_1f1b_schedule(S, M))


@pytest.mark.parametrize("S,M,V", [g for g in GRID if _valid(*g)])
def test_interleaved_tables_equal_jax(S, M, V):
    _assert_tables_equal(pipeline.build_interleaved_schedule(S, M, V),
                         j_pipeline.build_interleaved_schedule(S, M, V))


@pytest.mark.parametrize("S,M,V", [g for g in GRID if not _valid(*g)]
                         + [(0, 4, 1), (2, 0, 1), (2, 4, 0), (1, 4, 2)])
def test_interleaved_validation_errors_equal_jax(S, M, V):
    with pytest.raises(ValueError) as want:
        j_pipeline.build_interleaved_schedule(S, M, V)
    with pytest.raises(ValueError) as got:
        pipeline.build_interleaved_schedule(S, M, V)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("S,M", [(0, 1), (1, 0)])
def test_1f1b_validation_errors_equal_jax(S, M):
    with pytest.raises(ValueError) as want:
        j_pipeline.build_1f1b_schedule(S, M)
    with pytest.raises(ValueError) as got:
        pipeline.build_1f1b_schedule(S, M)
    assert str(got.value) == str(want.value)


def test_ring_depth_search_equals_jax():
    iv = {(1, 0): (0, 3), (1, 1): (2, 5), (1, 2): (4, 6), (2, 0): (1, 1)}
    for max_key in (0, 2, 5):
        assert (pipeline._min_ring_depth(iv, max_key)
                == j_pipeline._min_ring_depth(iv, max_key))


# ------------------------------------------------------------ stage splits


@pytest.mark.parametrize("num_stages,boundaries,n_blocks", [
    (1, None, 4), (2, None, 4), (3, None, 4), (4, None, 4), (3, None, 17),
    (4, [3, 9, 15], 17), (8, None, 17), (6, None, 8), (5, None, 0),
    (0, None, 4), (2, [1, 2], 4),
])
def test_split_points_equal_jax(num_stages, boundaries, n_blocks):
    try:
        want = j_staging.split_points(num_stages, boundaries, n_blocks)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("[", r"\[")):
            staging.split_points(num_stages, boundaries, n_blocks)
        return
    assert staging.split_points(num_stages, boundaries, n_blocks) == want


@pytest.mark.parametrize("logical,S,V", [(l, s, v) for s in (1, 2, 4)
                                         for v in (1, 2, 3)
                                         for l in range(s * v)])
def test_chunk_placement_equals_jax(logical, S, V):
    assert (staging.chunk_owner(logical, S)
            == j_staging.chunk_owner(logical, S))
    row = staging.row_of_logical(logical, S, V)
    assert row == j_staging.row_of_logical(logical, S, V)
    assert staging.logical_of_row(row, S, V) == logical
    assert (staging.logical_of_row(logical, S, V)
            == j_staging.logical_of_row(logical, S, V))


def _spec(tree):
    """{path: shape} of a tree of JAX avals."""
    return {jax.tree_util.keystr(p): tuple(a.shape)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _port_spec(tree):
    return _spec(jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype), params_spec(tree),
        is_leaf=lambda x: hasattr(x, "dtype")))


GPT_CFG = dict(vocab_size=32, dim=16, num_layers=5, num_heads=2, ffn_dim=32,
               max_position=8, dropout_rate=0.0)

SPLITS = {
    "tinycnn": (lambda n, b: j_tinycnn.split_stages(n, 10, boundaries=b),
                lambda n, b: tinycnn.split_stages(n, 10, boundaries=b),
                4),
    "mobilenetv2": (
        lambda n, b: j_mobilenetv2.split_stages(n, 10, boundaries=b),
        lambda n, b: mobilenetv2.split_stages(n, 10, boundaries=b), 17),
    "mobilenetv2_nobn": (
        lambda n, b: j_mobilenetv2.split_stages(n, 10, batchnorm=False,
                                                boundaries=b),
        lambda n, b: mobilenetv2.split_stages(n, 10, batchnorm=False,
                                              boundaries=b), 17),
    "resnet18": (
        lambda n, b: j_resnet.split_stages(18, n, 10, cifar=True,
                                           boundaries=b),
        lambda n, b: resnet.split_stages(18, n, 10, cifar=True,
                                         boundaries=b), 8),
    "gpt": (
        lambda n, b: j_gpt.split_stages(n, j_gpt.GPTConfig(**GPT_CFG),
                                        boundaries=b),
        lambda n, b: gpt.split_stages(n, gpt.GPTConfig(**GPT_CFG),
                                      boundaries=b), 5),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
@pytest.mark.parametrize("num_stages,boundaries", [(1, None), (2, None),
                                                   (4, None), (3, [1, 2])])
def test_assemble_stages_trees_equal_jax(name, num_stages, boundaries):
    """Each stage's params and state trees: the JAX stage's keys and
    shapes (conv weights compared in the JAX layout)."""
    j_split, t_split, _ = SPLITS[name]
    key = jax.random.PRNGKey(0)
    for j_stage, t_stage in zip(j_split(num_stages, boundaries),
                                t_split(num_stages, boundaries),
                                strict=True):
        jp, js = jax.eval_shape(j_stage.init, key)
        tp, ts = t_stage.init(torch.Generator())
        assert _port_spec(tp) == _spec(jp)
        assert _port_spec(ts) == _spec(js)


def _whole_tree(name):
    """A whole-model params tree of numpy arrays, each leaf distinct."""
    if name == "gpt":
        tree = jax.eval_shape(j_gpt.gpt_lm(j_gpt.GPTConfig(**GPT_CFG)).init,
                              jax.random.PRNGKey(0))[0]
    else:
        fn = {"tinycnn": lambda: j_tinycnn.tiny_cnn(10),
              "mobilenetv2": lambda: j_mobilenetv2.mobilenet_v2(10),
              "mobilenetv2_nobn": lambda: j_mobilenetv2.mobilenet_v2_nobn(10),
              "resnet18": lambda: j_resnet.resnet18(10),
              "resnet50": lambda: j_resnet.resnet50(10)}[name]
        tree = jax.eval_shape(fn().init, jax.random.PRNGKey(0))[0]
    leaves, treedef = jax.tree.flatten(tree)
    return jax.tree.unflatten(treedef, [np.full(a.shape, i, np.float32)
                                        for i, a in enumerate(leaves)])


PARTITIONS = {
    "tinycnn": (j_tinycnn.partition_pytree, tinycnn.partition_pytree),
    "mobilenetv2": (j_mobilenetv2.partition_pytree,
                    mobilenetv2.partition_pytree),
    "mobilenetv2_nobn": (j_mobilenetv2.partition_pytree,
                         mobilenetv2.partition_pytree),
    "resnet18": (lambda t, n, **kw: j_resnet.partition_pytree(t, 18, n, **kw),
                 lambda t, n, **kw: resnet.partition_pytree(t, 18, n, **kw)),
    "resnet50": (lambda t, n, **kw: j_resnet.partition_pytree(t, 50, n, **kw),
                 lambda t, n, **kw: resnet.partition_pytree(t, 50, n, **kw)),
}


def _assert_trees_identical(got, want):
    assert (jax.tree.structure(got) == jax.tree.structure(want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a is b


@pytest.mark.parametrize("name", sorted(PARTITIONS))
@pytest.mark.parametrize("num_stages,boundaries", [(1, None), (2, None),
                                                   (4, None), (3, [1, 3])])
def test_partition_pytree_equals_jax(name, num_stages, boundaries):
    tree = _whole_tree(name)
    j_part, t_part = PARTITIONS[name]
    got = t_part(tree, num_stages, boundaries=boundaries)
    _assert_trees_identical(got, j_part(tree, num_stages,
                                        boundaries=boundaries))
    cuts = staging.split_points(num_stages, boundaries,
                                len(tree["blocks"]))
    _assert_trees_identical(staging.unpartition_tree(got, cuts), tree)
    _assert_trees_identical(staging.unpartition_tree(got, cuts),
                            j_staging.unpartition_tree(got, cuts))


@pytest.mark.parametrize("cuts", [[0, 5], [0, 2, 5], [0, 1, 2, 4, 5]])
def test_partition_tree_of_the_gpt_equals_jax(cuts):
    tree = _whole_tree("gpt")
    got = staging.partition_tree(tree, cuts)
    _assert_trees_identical(got, j_staging.partition_tree(tree, cuts))
    _assert_trees_identical(staging.unpartition_tree(got, cuts), tree)
