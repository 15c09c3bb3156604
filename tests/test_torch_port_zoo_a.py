"""PyTorch port vs JAX package: the module zoo, part A.

Every row of tests/test_zoo_coverage.py's ``SINGLE_INPUT_BLOCKS`` goes
through the port's builder and must give the JAX ``YoloModel``'s raw head
maps, in fp32 eval, to atol 1e-5, from the same ``lively`` weights carried
across by ``state_dict_from_jax`` (``strict=True``). To keep the JAX
compiles few, rows are chained into one net a group (a block's input is
the block before it), cut so that the spatial size stays at least 8 at the
head. The state_dict of every group equals JAX's ``export_state_dict``.
Part A: the conv family, the SPP family and the stems, the Bottleneck
family; the activation specs; the shape ops bit-equal; ``model_info``
rows and ``format_model_info``'s text, GFLOPs at 640 px included, equal
JAX's for yolov7-tiny. Part B (tests/test_torch_port_zoo_b.py): the
rest, and the table of p6-lite.
"""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_port import (ANCHORS, ZOO_BLOCKS, ZOO_GROUPS, assert_state_dict_equals_export,
                         jax_and_port_maps, zoo_net)
from test_zoo_coverage import SINGLE_INPUT_BLOCKS
from yolo_continuous_tpu.nn import builder as jax_builder
from yolo_continuous_tpu.nn import layers as jax_layers
from yolo_continuous_tpu_torch.nn import layers
from yolo_continuous_tpu_torch.nn.builder import (YoloModel, build_model_spec, format_model_info,
                                                  model_info)

ATOL = 1e-5

GROUPS = ("conv", "spp", "stems", "bottleneck")


def test_groups_cover_their_rows():
    """tests/_torch_port.py's JAX-free copy of the rows is the coverage
    test's, and the chains of both parts take every row once."""
    assert ZOO_BLOCKS == SINGLE_INPUT_BLOCKS
    idx = sorted(i for g in ZOO_GROUPS.values() for i in g[1])
    assert idx == list(range(len(SINGLE_INPUT_BLOCKS)))
    assert [i for g in GROUPS for i in ZOO_GROUPS[g][1]] == list(range(24))


@pytest.mark.parametrize("group", GROUPS)
def test_block_chain_matches_jax(group):
    cfg, size = zoo_net(group)
    ref, ours, model, jax_tree = jax_and_port_maps(cfg, size)
    assert len(ours) == 3
    for o, r in zip(ours, ref):
        assert o.shape == r.shape and np.abs(r).max() > 0.1
        np.testing.assert_allclose(o, r, rtol=0, atol=ATOL)
    assert_state_dict_equals_export(jax_tree, model.spec)


ACTS = [True, "silu", ("leaky_relu", 0.1), "leaky_relu", "relu", "hardswish", False, None,
        "identity"]


@pytest.mark.parametrize("act", ACTS, ids=str)
def test_activation_spec_matches_jax(act):
    x = np.random.RandomState(3).randn(2, 5, 7, 3).astype(np.float32) * 4
    ours = layers.apply_act(torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_layers.apply_act(jnp.asarray(x), act)),
                               rtol=1e-6, atol=1e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        layers.apply_act(torch.zeros(1), "gelu")


@pytest.mark.parametrize("op", ["reorg", "contract", "expand", "chuncat", "foldcut"])
def test_shape_op_bit_equal_to_jax(op):
    """NCHW here, NHWC there: the same values in JAX's channel order."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 8, 12, 16).astype(np.float32)          # NHWC
    y = rs.randn(2, 8, 12, 6).astype(np.float32)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    if op == "chuncat":
        ours = layers.chuncat([nchw(x), nchw(y)])
        ref = jax_layers.chuncat([jnp.asarray(x), jnp.asarray(y)])
    else:
        ours = getattr(layers, op)(nchw(x))
        ref = getattr(jax_layers, op)(jnp.asarray(x))
    np.testing.assert_array_equal(ours.numpy().transpose(0, 2, 3, 1), np.asarray(ref))


def assert_model_table_equals_jax(cfg, anchors):
    """``model_info`` rows and ``format_model_info``'s text (GFLOPs at 640 px
    included) of the port's model against JAX's."""
    jm = jax_builder.YoloModel(spec=jax_builder.build_model_spec(cfg, 3, anchors, 80))
    v = jax.eval_shape(lambda k, x: jm.init(k, x, False), jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3)))
    model = YoloModel(build_model_spec(cfg, 3, anchors, 80))
    rows, summary = model_info(model)
    assert (rows, summary) == jax_builder.model_info(jm.spec, v["params"])
    text = format_model_info(model, 640)
    assert text == jax_builder.format_model_info(jm.spec, v["params"], 640, model=jm)
    assert "GFLOPs @ 640px" in text.splitlines()[-1]


def test_model_info_and_text_equal_jax():
    assert_model_table_equals_jax(yaml.safe_load(open("cfg/net/yolov7-tiny.yaml")), ANCHORS)


def test_gflops_errors_are_not_swallowed(monkeypatch):
    """Deliberate difference: JAX drops the figure when counting raises."""
    model = YoloModel(build_model_spec(yaml.safe_load(open("cfg/net/yolov7-tiny.yaml")), 3,
                                       ANCHORS, 2))

    def broken(*_):
        raise RuntimeError("count failed")
    monkeypatch.setattr("yolo_continuous_tpu_torch.nn.builder.model_gflops", broken)
    with pytest.raises(RuntimeError, match="count failed"):
        format_model_info(model)
