"""PyTorch port vs JAX package: weights bridge and eval forward.

A JAX ``YoloModel`` is initialised, its weights and BN statistics redrawn
from a numpy seed, and carried over with ``state_dict_from_jax``; the raw
head maps must match ``YoloModel.apply`` in eval, in fp32. Tolerances are
those of tests/test_torch_import.py (summation order differs between XLA
and torch convolutions).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

import jax
import jax.numpy as jnp

from _torch_port import ANCHORS, lively
from yolo_continuous_tpu.nn.builder import YoloModel as JaxModel
from yolo_continuous_tpu.nn.builder import build_model_spec as jax_spec
from yolo_continuous_tpu.tools.torch_import import export_state_dict
from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
from yolo_continuous_tpu_torch.nn.heads import head_view
from yolo_continuous_tpu_torch.nn.layers import LogitConv
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax

# net, classes, image size, (atol, rtol)
CASES = {"yolov7-tiny": (2, 96, (2e-3, 1e-3)), "yolov7": (1, 64, (5e-3, 2e-3)),
         "repconv-identity": (2, 32, (2e-3, 1e-3))}
# the shipped nets never give a RepConv c1 == c2, so this one exercises the
# bare-BN identity branch (rbr_identity) and its state_dict keys
REPCONV_NET = {"depth_multiple": 1.0, "width_multiple": 1.0,
               "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "RepConv", [16, 3, 1]],
                            [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]]],
               "head": [[[1, 2, 3], 1, "Detect", ["nc", "anchors"]]]}


def _net(net):
    return REPCONV_NET if net == "repconv-identity" else yaml.safe_load(open(f"cfg/net/{net}.yaml"))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    net = request.param
    nc, size, tol = CASES[net]
    cfg = _net(net)
    spec = jax_spec(cfg, 3, ANCHORS, nc)
    x = np.random.RandomState(0).rand(2, size, size, 3).astype(np.float32)
    v = JaxModel(spec=spec).init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), False)
    rs = np.random.RandomState(1)
    params, stats = lively(v["params"], rs), lively(v["batch_stats"], rs)
    maps = JaxModel(spec=spec).apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(x), False)
    return dict(net=net, spec=spec, port_spec=build_model_spec(cfg, 3, ANCHORS, nc),
                params=params, stats=stats, x=x, maps=[np.asarray(m) for m in maps], tol=tol)


def _port_model(case):
    sd = state_dict_from_jax(case["port_spec"], case["params"], case["stats"])
    model = YoloModel(case["port_spec"])
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_state_dict_equals_export(case):
    """The same keys and values as the JAX package's export_state_dict, plus
    the num_batches_tracked that nn.BatchNorm2d expects."""
    ours = state_dict_from_jax(case["port_spec"], case["params"], case["stats"])
    ref = export_state_dict(case["spec"], case["params"], case["stats"])
    tracked = {k for k in ours if k.endswith("num_batches_tracked")}
    assert set(ours) - tracked == set(ref)
    assert tracked == {k.replace("running_mean", "num_batches_tracked")
                       for k in ref if k.endswith("running_mean")}
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_state_dict_loads_strict(case):
    model = _port_model(case)
    keys = set(model.state_dict())
    assert any(".rbr_identity.running_var" in k for k in keys) == (case["net"] == "repconv-identity")
    assert any(".rbr_dense.1.running_var" in k for k in keys) == (case["net"] != "yolov7-tiny")
    assert any(".yolo_head_P3.weight" in k for k in keys)


def test_forward_matches_jax(case):
    model = _port_model(case)
    with torch.no_grad():
        ours = model(torch.from_numpy(case["x"]).permute(0, 3, 1, 2).contiguous())
    assert len(ours) == len(case["maps"]) == 3
    atol, rtol = case["tol"]
    for o, r in zip(ours, case["maps"]):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r, atol=atol, rtol=rtol)


def test_head_map_is_a_view_in_jax_order():
    """Regression (candidate order): the raw map is a view of the NCHW conv
    output, and flattening it gives the JAX (h, w, na) row order, not the
    (na, h, w) order a plain flatten of the NCHW tensor would give."""
    bs, na, no, h, w = 2, 3, 6, 4, 5
    y = torch.randn(bs, na * no, h, w)
    v = head_view(y, na, no)
    assert v.data_ptr() == y.data_ptr() and tuple(v.shape) == (bs, h, w, na, no)
    nhwc = y.permute(0, 2, 3, 1).numpy()                 # what the JAX conv emits
    rows_jax = nhwc.reshape(bs, h, w, na, no).reshape(bs, h * w * na, no)
    np.testing.assert_array_equal(v.reshape(bs, -1, no).numpy(), rows_jax)
    naive = y.view(bs, na, no, h * w).transpose(2, 3).reshape(bs, -1, no).numpy()
    assert not np.array_equal(naive, rows_jax)


def test_logit_conv_keeps_fp32_logits():
    """Regression (head precision): with a bf16 body the head multiplies
    bf16-rounded values but sums and stores fp32 (layers.py:160-193); a
    bf16 conv would round the logits themselves to bf16."""
    torch.manual_seed(0)
    conv = LogitConv(64, 21)
    conv.mult_dtype = torch.bfloat16
    x = torch.randn(2, 64, 5, 5)
    with torch.no_grad():
        y = conv(x)
        ref = F.conv2d(x.bfloat16().float(), conv.weight.bfloat16().float(), conv.bias)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, ref, atol=1e-5, rtol=1e-5)
    assert not torch.equal(y, y.bfloat16().float())     # not rounded to bf16


def test_bf16_body_casts_convs_not_bn_or_head():
    spec = build_model_spec(yaml.safe_load(open("cfg/net/yolov7-tiny.yaml")), 3, ANCHORS, 2)
    model = YoloModel(spec).eval().set_dtype(torch.bfloat16)
    assert model.model[0].conv.weight.dtype == torch.bfloat16
    assert model.model[0].bn.running_var.dtype == torch.float32
    head = model.model[spec.head_index]
    assert head.yolo_head_P3.weight.dtype == torch.float32
    assert head.yolo_head_P3.mult_dtype == torch.bfloat16
    with torch.no_grad():
        maps = model(torch.rand(1, 3, 64, 64))
    assert all(m.dtype == torch.float32 and torch.isfinite(m).all() for m in maps)
