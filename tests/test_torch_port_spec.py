"""PyTorch port vs JAX package: plans, model specs, box math, pooling.

The port keeps its own copies of the pure-Python spec code; these tests
hold each copy equal to the JAX original on every shipped config.
"""
import dataclasses
import glob

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from _torch_port import ANCHORS
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.nn import layers as jax_layers
from yolo_continuous_tpu.nn.builder import build_model_spec as jax_spec
from yolo_continuous_tpu.ops import boxes as jax_boxes
from yolo_continuous_tpu_torch.config import plan as plan_mod
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.nn import layers
from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model, build_model_spec
from yolo_continuous_tpu_torch.ops import boxes

NETS = ["yolov7.yaml", "yolov7-tiny.yaml", "yolov7-aux.yaml", "yolov7-p6-lite.yaml",
        "yolov7-w6.yaml"]
PLANS = ["chip_tiny.yaml", "coco_train.yaml", "raccoon.yaml", "raccoon_tiny.yaml",
         "voc_train.yaml"]
P6_ANCHORS = [[19, 27, 44, 40, 38, 94], [96, 68, 86, 152, 180, 137],
              [140, 301, 303, 264, 238, 542], [436, 615, 739, 380, 925, 792]]


def test_lists_cover_every_cfg():
    assert sorted(NETS) == sorted(p.split("/")[-1] for p in glob.glob("cfg/net/*.yaml"))
    assert sorted(PLANS) == sorted(p.split("/")[-1] for p in glob.glob("cfg/*.yaml"))


def _spec_args(net):
    cfg = yaml.safe_load(open(f"cfg/net/{net}"))
    if "p6" in net or "w6" in net:
        return cfg, 3, P6_ANCHORS, 2, [[9, 10, 11], [6, 7, 8], [3, 4, 5], [0, 1, 2]]
    return cfg, 3, ANCHORS, 80, None


@pytest.mark.parametrize("net", NETS)
def test_model_spec_equal(net):
    ours = build_model_spec(*_spec_args(net))
    ref = jax_spec(*_spec_args(net))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("plan", PLANS)
def test_train_plan_equal(plan):
    ours, ref = TrainPlan(f"cfg/{plan}"), JaxPlan(f"cfg/{plan}")
    assert vars(ours) == vars(ref)


@pytest.mark.parametrize("path", sorted(glob.glob("cfg/**/*.yaml", recursive=True)))
def test_yaml_subset_loader_equals_pyyaml(path):
    text = open(path).read()
    assert plan_mod.load_yaml_subset(text) == yaml.safe_load(text)


def test_train_plan_without_pyyaml(monkeypatch):
    monkeypatch.setattr(plan_mod, "yaml", None)
    assert vars(TrainPlan("cfg/coco_train.yaml")) == vars(JaxPlan("cfg/coco_train.yaml"))


@pytest.mark.parametrize("text", ["a: [1, 2", "a: [1 [2]]", "a: 1, 2", "- [1]",
                                  "a:\n  b: 1", "a: |", "a: b: c", "a: {b: 1}", "a: &x 1"])
def test_yaml_subset_loader_refuses_the_rest(text):
    with pytest.raises(ValueError):
        plan_mod.load_yaml_subset(text)


def test_unported_rows_raise_with_their_roadmap_item():
    """Every row of the zoo is ported now (p6-lite's ReOrg and DownC build);
    a row JAX does not know raises as JAX's ``unknown module``."""
    cfg, chan, anchors, nc, mask = _spec_args("yolov7-p6-lite.yaml")
    assert len(build_model(cfg, anchors, nc, chan, mask).model) == 71
    net = {"depth_multiple": 1.0, "width_multiple": 1.0,
           "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "NoSuchBlock", []]],
           "head": [[[0, 1, 1], 1, "Detect", ["nc", "anchors"]]]}
    with pytest.raises(ValueError, match="unknown module 'NoSuchBlock' at layer 1"):
        YoloModel(build_model_spec(net, 3, ANCHORS, 2))


@pytest.mark.parametrize("flag", list(boxes.CvtFlag), ids=lambda f: f.name)
def test_cvt_bbox_matches_jax(flag):
    b = np.random.RandomState(0).rand(2, 7, 4).astype(np.float32)
    ours = boxes.cvt_bbox(torch.from_numpy(b), flag).numpy()
    ref = np.asarray(jax_boxes.cvt_bbox(jnp.asarray(b), jax_boxes.CvtFlag[flag.name]))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-7)


def test_box_iou_matches_jax():
    rs = np.random.RandomState(1)
    xy = rs.rand(2, 30, 2)
    b = np.concatenate([xy, xy + rs.rand(2, 30, 2) * 0.4], -1).astype(np.float32)
    b[0, 3] = b[0, 4] = [0.5, 0.5, 0.5, 0.5]              # zero-area pair: NaN on both
    ours = boxes.box_iou(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_boxes.box_iou(jnp.asarray(b), jnp.asarray(b)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    assert np.isnan(ours[0, 3, 4]) and not (ours[0, 3, 4] > 0.45)


@pytest.mark.parametrize("ks", [(5, 9, 13), (5, 3)])
def test_sp_pyramid_matches_jax(ks):
    """The -inf padded cascade equals the JAX pools (NCHW here, NHWC there)."""
    x = np.random.RandomState(2).randn(2, 11, 9, 4).astype(np.float32)
    ours = layers.sp_pyramid(torch.from_numpy(x.transpose(0, 3, 1, 2)), ks)
    ref = jax_layers.sp_pyramid(jnp.asarray(x), ks)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy().transpose(0, 2, 3, 1), np.asarray(r))
    np.testing.assert_array_equal(
        layers.mp(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1),
        np.asarray(jax_layers.mp(jnp.asarray(x))))
