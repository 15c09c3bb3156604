"""PyTorch port vs JAX package: the IDetect / IAuxDetect / IBin heads.

The tiny 3-level nets of tests/test_head_variants.py for each I-head, and
``cfg/net/yolov7-aux.yaml``, at 64 px in fp32. JAX weights are redrawn with
``lively`` and carried over with ``state_dict_from_jax``; every raw map must
match ``YoloModel.apply`` in eval within the tolerances of
tests/test_torch_port_model.py. The IBin ``Detector`` runs end to end
against the JAX one (keep-set equal, boxes within 1e-4), as
tests/test_torch_port_detector.py does for Detect.
"""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_port import (ANCHORS, lively, min_bin_gap, min_score_gap, tiny_head_net,
                         tiny_plan_cfg)
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu.nn.builder import YoloModel as JaxModel
from yolo_continuous_tpu.nn.builder import build_model_spec as jax_spec
from yolo_continuous_tpu.tools.torch_import import export_state_dict
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.nn import layers
from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
from yolo_continuous_tpu_torch.ops.decode import decode_outputs_bin
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax

SIZE = 64
# net -> (classes, (atol, rtol)); the tolerances of test_torch_port_model.py
CASES = {"IDetect": (2, (2e-3, 1e-3)), "IAuxDetect": (2, (2e-3, 1e-3)), "IBin": (2, (2e-3, 1e-3)),
         "yolov7-aux": (1, (5e-3, 2e-3))}


def _net(name):
    return yaml.safe_load(open(f"cfg/net/{name}.yaml")) if name.startswith("yolov7") \
        else tiny_head_net(name)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name = request.param
    nc, tol = CASES[name]
    cfg = _net(name)
    spec = jax_spec(cfg, 3, ANCHORS, nc)
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    # lively redraws every leaf, so init is traced for its shapes only
    v = jax.eval_shape(lambda x0: JaxModel(spec=spec).init(jax.random.PRNGKey(0), x0, False),
                       jnp.asarray(x[:1]))
    rs = np.random.RandomState(1)
    params, stats = lively(v["params"], rs), lively(v["batch_stats"], rs)
    maps = JaxModel(spec=spec).apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(x), False)
    return dict(name=name, spec=spec, port_spec=build_model_spec(cfg, 3, ANCHORS, nc),
                params=params, stats=stats, x=x, maps=[np.asarray(m) for m in maps], tol=tol)


def _port_model(case):
    model = YoloModel(case["port_spec"])
    model.load_state_dict(state_dict_from_jax(case["port_spec"], case["params"], case["stats"]),
                          strict=True)
    return model.eval()


def test_state_dict_equals_export(case):
    ours = state_dict_from_jax(case["port_spec"], case["params"], case["stats"])
    ref = export_state_dict(case["spec"], case["params"], case["stats"])
    assert {k for k in ours if not k.endswith("num_batches_tracked")} == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_state_dict_loads_strict(case):
    keys = set(_port_model(case).state_dict())
    head = f"model.{case['port_spec'].head_index}"
    for i in range(3):
        assert {f"{head}.ia.{i}.implicit", f"{head}.m.{i}.weight", f"{head}.m.{i}.bias",
                f"{head}.im.{i}.implicit"} <= keys
        assert (f"{head}.m2.{i}.weight" in keys) == (case["port_spec"].head_name == "IAuxDetect")


def test_forward_matches_jax(case):
    with torch.no_grad():
        ours = _port_model(case)(torch.from_numpy(case["x"]).permute(0, 3, 1, 2).contiguous())
    n_maps = 6 if case["port_spec"].head_name == "IAuxDetect" else 3
    assert len(ours) == len(case["maps"]) == n_maps
    assert case["port_spec"].strides == (8, 16, 32)                  # P3 first
    atol, rtol = case["tol"]
    for o, r in zip(ours, case["maps"]):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r, atol=atol, rtol=rtol)


def test_implicit_priors_init_and_dtype():
    """init_weights draws ImplicitA around 0 and ImplicitM around 1 (the JAX
    fix); with a bf16 body ImplicitA adds in bf16 and ImplicitM keeps the
    fp32 logits fp32."""
    spec = build_model_spec(tiny_head_net("IDetect"), 3, ANCHORS, 2)
    model = YoloModel(spec).init_weights(torch.Generator().manual_seed(0)).eval()
    head = model.model[spec.head_index]
    a = torch.cat([m.implicit.flatten() for m in head.ia])
    m = torch.cat([m.implicit.flatten() for m in head.im])
    assert abs(a.mean().item()) < 0.01 and abs(m.mean().item() - 1.0) < 0.01
    assert 0.01 < a.std().item() < 0.03 and 0.01 < m.std().item() < 0.03
    x = torch.randn(2, 16, 3, 3)
    assert head.ia[0](x.bfloat16()).dtype == torch.bfloat16
    assert head.im[0](torch.randn(2, 21, 3, 3)).dtype == torch.float32
    model.set_dtype(torch.bfloat16)
    assert head.m[0].mult_dtype == torch.bfloat16 and head.im[0].implicit.dtype == torch.float32
    with torch.no_grad():
        maps = model(torch.rand(1, 3, SIZE, SIZE))
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in maps)


# --- the IBin Detector end to end -------------------------------------------

CONF, IOU, MAX_DET = 0.01, 0.45, 100
WEIGHT_SEED, HEAD_GAIN = 2, 2.0   # chosen so that the top-k scores and the bins are 1e-5 apart


def test_ibin_detector_matches_jax():
    jax_plan = JaxPlan(tiny_plan_cfg("IBin", SIZE))
    jax_det = JaxDetector(jax_plan, dtype=jnp.float32)
    rs = np.random.RandomState(WEIGHT_SEED)
    params, stats = lively(jax_det.params, rs), lively(jax_det.batch_stats, rs)
    params["ibin"] = {name: {k: v * HEAD_GAIN if k == "kernel" else v for k, v in p.items()}
                      for name, p in params["ibin"].items()}
    jax_det = JaxDetector(jax_plan, dtype=jnp.float32, params=params, batch_stats=stats)
    det = Detector(TrainPlan(tiny_plan_cfg("IBin", SIZE)), device="cpu",
                   state_dict=state_dict_from_jax(jax_det.spec, params, stats))
    assert det.spec.head_name == "IBin" and det.spec.bin_count == 21

    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    with torch.no_grad():
        maps = det.forward(x)
        pred = decode_outputs_bin(maps, det.spec.anchors, det.spec.strides, 21)
    assert min(min_bin_gap(m.numpy()) for m in maps) > 1e-5              # no argmax ties
    score = (pred[..., 4] * pred[..., 5:].max(-1).values).numpy()
    assert min_score_gap(np.where(score >= CONF, score, -1.0), MAX_DET) > 1e-5   # no top-k ties

    ours = [t.numpy() for t in det(x, CONF, IOU, MAX_DET)]
    ref = [np.asarray(t) for t in jax_det(jnp.asarray(x), CONF, IOU, MAX_DET)]
    valid = ref[3]
    np.testing.assert_array_equal(ours[3], valid)
    assert 0 < valid.sum(1).min() and valid.sum(1).max() < MAX_DET     # NMS dropped some
    np.testing.assert_allclose(ours[0][valid], ref[0][valid], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours[1][valid], ref[1][valid], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours[2][valid], ref[2][valid])


def test_aux_detector_keeps_the_leads():
    """Detector.forward of an IAuxDetect net returns the nl lead maps only."""
    cfg = tiny_plan_cfg("IAuxDetect", SIZE)
    det = Detector(TrainPlan(cfg), device="cpu")
    maps = det.forward(np.zeros((1, SIZE, SIZE, 3), np.float32))
    assert [tuple(m.shape[1:3]) for m in maps] == [(8, 8), (4, 4), (2, 2)]
    boxes, _, _, _ = det(np.zeros((1, SIZE, SIZE, 3), np.float32), 0.001, 0.45, 10)
    assert tuple(boxes.shape) == (1, 10, 4) and torch.isfinite(boxes).all()
    assert isinstance(det.model.model[det.spec.head_index].m2[0], layers.LogitConv)
