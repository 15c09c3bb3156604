"""YOLOv7-W6 (``cfg/net/yolov7-w6.yaml``, ``benchmark/configs/yolov7-w6.json``)
on the port against the benchmark's plain reference, on the CPU in fp32.

- At published widths, on the ``meta`` device: the port's model and the
  reference's (``benchmark/reference/p6_model.py``) hold the same state-dict
  names and shapes; 82.31M parameters in the training form and 70.43M
  without the auxiliary branch (rows 118-121 and ``m2``); the reference's
  forward FLOPs at 1280, 420.1e9 an image in the training form and 359.7e9
  deployed (the paper's 360.0).
- At a sixteenth of the widths, 128 px, batch 2, on weights drawn as the
  benchmark draws them (implicit rows N(0, 0.02^2) and N(1, 0.02^2)): the
  eight maps, the loss and its parts with the auxiliary positives
  (``benchmark/reference/aux_loss.py``), and the first gradient's leaves.
- The captured step's marks: an auxiliary net's sequence holds ``step_aux``
  between ``step_loss`` and ``step_backward``; a ``Detect`` net's does not.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import tiny_plan_cfg
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
from yolo_continuous_tpu_torch.train import train_loop
from yolo_continuous_tpu_torch.train.train_loop import Trainer
from yolo_continuous_tpu_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
if str(REPO / "benchmark") not in sys.path:
    sys.path.insert(0, str(REPO / "benchmark"))

from harness.train_aux import draw_weights  # noqa: E402
from reference.aux_loss import aux_yolo_loss  # noqa: E402
from reference.p6_model import P6Yolo, forward_flops, state_shapes  # noqa: E402

CFG = json.loads((REPO / "benchmark" / "configs" / "yolov7-w6.json").read_text())
AUX_ROWS = ("118", "119", "120", "121")
SEED = 2 ** 34 + 5


def _spec(cfg):
    return build_model_spec({k: cfg[k] for k in ("depth_multiple", "width_multiple", "backbone",
                                                 "head")},
                            3, cfg["anchors"], cfg["num_classes"], cfg["anchors_mask"])


def _small():
    return dict(CFG, image_size=128, width_multiple=1 / 16)


def test_the_yaml_holds_the_configurations_rows():
    import yaml
    net = yaml.safe_load((REPO / "cfg" / "net" / "yolov7-w6.yaml").read_text())
    none = (lambda rows: [[f, n, m, ["None" if a is None else a for a in args]]
                          for f, n, m, args in rows])
    assert none(net["backbone"]) == CFG["backbone"] and none(net["head"]) == CFG["head"]


def test_published_widths_names_parameters_and_flops():
    with torch.device("meta"):
        port = YoloModel(_spec(CFG))
    mine = [(k, tuple(v.shape), v.dtype) for k, v in port.state_dict().items()]
    assert mine == state_shapes(CFG)
    total = sum(p.numel() for p in port.parameters())
    aux = sum(p.numel() for n, p in port.named_parameters()
              if n.split(".")[1] in AUX_ROWS or ".m2." in n)
    assert round(total / 1e6, 2) == 82.31 and round((total - aux) / 1e6, 2) == 70.43
    assert forward_flops(CFG) == pytest.approx(420.1e9, rel=5e-3)
    assert forward_flops(CFG, aux=False) == pytest.approx(359.7e9, rel=5e-3)


def _batch(seed, nc=80, bs=2, size=128):
    rs = np.random.RandomState(seed)
    labels = np.zeros((bs, 8, 5), np.float32)
    lmask = np.zeros((bs, 8), bool)
    for b in range(bs):
        for g in range(3 + 2 * b):
            labels[b, g] = [rs.randint(nc), rs.uniform(.2, .8), rs.uniform(.2, .8),
                            rs.uniform(.1, .6), rs.uniform(.1, .6)]
            lmask[b, g] = True
    return (torch.from_numpy(rs.rand(bs, size, size, 3).astype(np.float32)),
            torch.from_numpy(labels), torch.from_numpy(lmask))


@pytest.fixture(scope="module")
def pair():
    """The port's Trainer and the reference model on the same seeded
    weights, at a sixteenth of the widths and 128 px."""
    cfg = _small()
    plan = dict(tiny_plan_cfg("IAuxDetect", 128), model_cfg={
        k: cfg[k] for k in ("depth_multiple", "width_multiple", "backbone", "head")},
        anchors=cfg["anchors"], anchors_mask=cfg["anchors_mask"],
        labels=[f"c{i}" for i in range(80)], max_boxes=8)
    tr = Trainer(TrainPlan(plan), device="cpu")
    w = draw_weights(cfg, SEED, "cpu")
    tr.init_state(state_dict=w)
    ref = P6Yolo(cfg)
    ref.load_state_dict(w)
    return tr, ref, cfg


def test_the_eight_maps_match_the_reference(pair):
    tr, ref, _ = pair
    x = _batch(1)[0].permute(0, 3, 1, 2).contiguous()
    assert tr.spec.strides == ref.strides and tr.spec.anchors == ref.anchors
    with torch.no_grad():
        for mode in ("eval", "train"):
            a, b = getattr(tr.model, mode)()(x), getattr(ref, mode)()(x)
            assert len(a) == len(b) == 8
            for p, q in zip(a, b):
                assert p.shape == q.shape
                assert (p - q).abs().max() <= 1e-5 * q.abs().max()


def test_the_loss_and_first_gradient_match_the_reference(pair):
    tr, ref, cfg = pair
    images, labels, lmask = _batch(2)
    x = images.permute(0, 3, 1, 2).contiguous()
    model = tr.model.train()
    model.zero_grad(set_to_none=True)
    ref.train().zero_grad(set_to_none=True)
    loss, parts = tr.loss_from_outputs(model(x), labels, lmask)
    loss.backward()
    maps = ref(x)
    want, wparts = aux_yolo_loss(maps[:4], maps[4:], labels, lmask, 80, ref.strides,
                                 ref.anchors, cfg["image_size"])
    want.backward()
    assert int(parts["num_fg"]) == int(wparts["num_fg"]) > 0
    assert int(parts["num_fg_aux"]) == int(wparts["num_fg_aux"]) > int(parts["num_fg"])
    np.testing.assert_allclose(float(loss.detach()), float(want.detach()), rtol=1e-5)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(float(parts[k].detach()), float(wparts[k].detach()), rtol=1e-5,
                                   err_msg=k)
    grads = dict(ref.named_parameters())
    for n, p in model.named_parameters():
        g, r = p.grad, grads[n].grad
        assert (g - r).norm() <= 1e-4 * r.norm() + 1e-9, n


def _marks_of_captured_steps(monkeypatch, head, steps=2):
    from test_torch_port_train_capture import CpuStep
    monkeypatch.setattr(train_loop, "CapturedStep", CpuStep)
    tr = Trainer(TrainPlan(tiny_plan_cfg(head, 64)), device="cpu")
    state = tr.init_state(seed=0)
    images, labels, lmask = _batch(3, nc=2, size=64)
    out = []
    for _ in range(steps):
        with trace.recording() as marks:
            _, metrics = tr._replayed_step(state, images, labels, lmask, 0.01, 0.1, 0.9)
        out.append((marks, metrics))
    return out


@pytest.mark.parametrize("head", ["IAuxDetect", "Detect"])
def test_the_captured_step_marks_the_auxiliary_pass(monkeypatch, head):
    lead = ["step_forward", "step_loss"]
    rest = ["step_backward", "step_optimizer", "step_ema", "step_end"]
    aux = head == "IAuxDetect"
    for marks, metrics in _marks_of_captured_steps(monkeypatch, head):
        assert marks == lead + (["step_aux"] if aux else []) + rest
        assert ("num_fg_aux" in metrics) == aux
        if aux:
            assert int(metrics["num_fg_aux"]) >= int(metrics["num_fg"]) > 0
