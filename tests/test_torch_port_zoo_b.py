"""PyTorch port vs JAX package: the module zoo, part B, and the model table.

As tests/test_torch_port_zoo_a.py (raw maps of chained rows, fp32 eval,
atol 1e-5): the Res, ResX and Ghost families, the pools, the shape rows,
``nn.BatchNorm2d``, the ``ImplicitA``/``ImplicitM`` rows and
``TransformerBlock``; test_zoo_coverage.py's multi-input and repeat nets;
``TransformerBlock`` (with its conv) and ``Classify`` as modules. The
state_dict of every group equals JAX's ``export_state_dict`` but for the
attention, which export has no rule for (the port's ``tr.{i}`` and
``ma.in_proj_*``). The model table of p6-lite as part A's of yolov7-tiny.
"""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import test_torch_port_zoo_a as zoo_a
from _torch_port import (ZOO_BLOCKS, ZOO_GROUPS, ZOO_NETS, assert_state_dict_equals_export,
                         jax_and_port_maps, lively, zoo_net)
from test_p6_model import P6_ANCHORS
from yolo_continuous_tpu.nn import layers as jax_layers
from yolo_continuous_tpu_torch.nn import layers
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax

ATOL = 1e-5

GROUPS = ("res", "resx", "ghost", "reshape", "multi_input", "repeat")


def test_chip_smoke_sweeps_the_same_rows():
    """chip_smoke.py's phase 7 keeps its own copy of the rows (it imports no
    test code): the same groups and nets."""
    import chip_smoke
    assert chip_smoke.ZOO_BLOCKS == ZOO_BLOCKS and chip_smoke.ZOO_NETS == ZOO_NETS
    assert {g: (s, list(i), e) for g, (s, i, e) in chip_smoke.ZOO_GROUPS.items()} == \
        {g: (s, list(i), e) for g, (s, i, e) in ZOO_GROUPS.items()}


@pytest.mark.parametrize("group", GROUPS)
def test_block_chain_matches_jax(group):
    cfg, size = zoo_net(group)
    ref, ours, model, jax_tree = jax_and_port_maps(cfg, size)
    for o, r in zip(ours, ref):
        assert o.shape == r.shape and np.abs(r).max() > 0.1
        np.testing.assert_allclose(o, r, rtol=0, atol=ATOL)
    assert_state_dict_equals_export(jax_tree, model.spec, attention=group == "ghost")
    if group == "repeat":
        assert isinstance(model.model[1], torch.nn.Sequential) and len(model.model[2].m) == 2


def _module_pair(jax_module, port_module, x_nhwc, seed=5):
    """A JAX module's output and the port module's, from lively weights
    carried across under the module's own name."""
    v = jax.eval_shape(lambda k, a: jax_module.init(k, a), jax.random.PRNGKey(0), x_nhwc)
    rs = np.random.RandomState(seed)
    params = lively(v["params"], rs)
    stats = lively(v.get("batch_stats", {}), rs)
    ref = jax_module.apply({"params": params, "batch_stats": stats}, x_nhwc)
    sd = state_dict_from_jax(None, {"l0_X": params}, {"l0_X": stats})
    port_module.load_state_dict({k[len("model.0."):]: v for k, v in sd.items()}, strict=True)
    return np.asarray(ref), port_module.eval()


def test_transformer_block_with_its_conv_matches_jax():
    """c1 != c2: the Conv, the position linear, two layers; the attention
    runs over the batch axis of (tokens, batch, c), as flax reads it."""
    x = np.random.RandomState(6).randn(3, 4, 5, 8).astype(np.float32)
    ref, m = _module_pair(jax_layers.TransformerBlock(8, 16, 4, 2), layers.TransformerBlock(8, 16, 4, 2),
                          jnp.asarray(x))
    with torch.no_grad():
        ours = m(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_classify_matches_jax():
    rs = np.random.RandomState(7)
    xs = [rs.randn(2, 6, 6, 8).astype(np.float32), rs.randn(2, 3, 3, 4).astype(np.float32)]
    jm = jax_layers.Classify(5)
    v = jax.eval_shape(lambda k: jm.init(k, [jnp.asarray(a) for a in xs]), jax.random.PRNGKey(0))
    params = lively(v["params"], rs)
    ref = np.asarray(jm.apply({"params": params}, [jnp.asarray(a) for a in xs]))
    m = layers.Classify(12, 5)
    sd = state_dict_from_jax(None, {"l0_X": params}, {})
    m.load_state_dict({k[len("model.0."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = m([torch.from_numpy(a.transpose(0, 3, 1, 2).copy()) for a in xs]).numpy()
    assert ours.shape == ref.shape == (2, 5)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("net", ["yolov7-p6-lite"])
def test_model_info_and_text_equal_jax(net):
    zoo_a.assert_model_table_equals_jax(yaml.safe_load(open(f"cfg/net/{net}.yaml")), P6_ANCHORS)
