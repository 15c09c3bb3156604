"""What decides ``correct``: the plain reference against the port on the CPU
at small sizes, and the control and each planted fault coming out as not
correct. Sizes: yolov7-tiny's rows at 64 px, two images a batch."""
from __future__ import annotations

import json

import pytest
import torch

from harness import common as C

from _small import run_small, small_cell

import controls

SEED = 2 ** 35 + 11


def test_the_reference_model_is_the_ports_model():
    from reference.model import PlainYolo, state_shapes
    from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
    for name in ("yolov7-tiny", "yolov7"):
        cfg = C.load_json(C.BENCH / "configs" / f"{name}.json")
        w = C.make_weights(state_shapes(cfg), SEED, "cpu")
        spec = build_model_spec({k: cfg[k] for k in ("depth_multiple", "width_multiple",
                                                     "backbone", "head")},
                                3, cfg["anchors"], cfg["num_classes"], cfg["anchors_mask"])
        port, ref = YoloModel(spec), PlainYolo(cfg)
        port.load_state_dict(w)
        ref.load_state_dict(w)
        assert spec.anchors == ref.anchors and spec.strides == ref.strides
        x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            for mode in ("eval", "train"):
                a, b = getattr(port, mode)()(x), getattr(ref, mode)()(x)
                for p, q in zip(a, b):
                    # train mode: the port's E[x^2] - E[x]^2 variance against a
                    # two-pass one, over as few as 8 values a channel at P5
                    tol = 1e-5 if mode == "eval" else 1e-3
                    assert (p - q).abs().max() <= tol * q.abs().max()


def test_a_request_agrees_with_the_reference_on_the_cpu():
    res = run_small("yolov7.detect.val", SEED, seconds=1.0)
    # fp32 on both sides: the same kept detections, to rounding
    chk = {k: v["value"] for k, v in res["checks"].items()}
    assert chk["det_gap"] < 1e-4 and chk["missed"] == 0.0 and chk["extra"] == 0.0
    assert res["correct"]


def test_a_train_step_agrees_with_the_reference_on_the_cpu():
    chk = {}
    res = run_small("yolov7.train.stager", SEED, seconds=0.5, numbers=chk)
    # the same draws and geometry: the pixels differ by the program's fp32
    # rounding against the reference's fp64, the boxes not at all
    assert chk["aug_image_off"] == 0.0 and chk["aug_label_gap"] < 1e-6
    assert chk["aug_mask_diff"] == 0.0 and chk["loss_finite"] == 0.0
    # fp32 on both sides and the program's batches: the first step agrees to
    # rounding, the later ones nearly
    assert chk["loss_gap_first"] < 1e-6 and chk["grad_gap"] < 1e-5
    assert chk["loss_gap"] < 1e-4 and chk["change_gap_median"] < 1e-3
    assert chk["ema_gap_median"] < 1e-4
    assert res["correct"]


def test_the_int8_control_is_not_correct():
    name = "yolov7.detect.val"
    out = controls.run_one(name, "control", SEED, 1.0, "cpu", small_cell(name))
    assert not out["correct"], json.dumps(out)


def test_the_fp8_control_of_training_is_not_correct():
    out = controls.run_one("yolov7.train.stager", "control", SEED, 0.5, "cpu",
                           small_cell("yolov7.train.stager"))
    assert not out["correct"], json.dumps(out)


def test_kept_sets_are_matched_detection_to_detection():
    from reference.compare import detection_gaps
    box = torch.tensor([[0.1, 0.1, 0.3, 0.3], [0.5, 0.5, 0.9, 0.8], [0.12, 0.1, 0.3, 0.3]])
    ref = [(box[:2], torch.tensor([0.9, 0.5]), torch.tensor([1, 2]))]
    same = detection_gaps([(box[:2].clone(), torch.tensor([0.9, 0.5]), torch.tensor([1, 2]))],
                          ref)
    assert same == {"det_gap": 0.0, "missed": 0.0, "extra": 0.0}
    # an overlapping box left unsuppressed, one of another class, one missing
    out = detection_gaps([(box[[0, 2, 1]], torch.tensor([0.9, 0.8, 0.5]),
                           torch.tensor([1, 1, 3]))], ref)
    assert out["missed"] == 0.5 and out["extra"] == 2 / 3 and out["det_gap"] == 0.0
    # a moved box and a halved score: matched, with its gap
    moved = detection_gaps([(box[[2, 1]], torch.tensor([0.9, 0.25]), torch.tensor([1, 2]))],
                           ref)
    assert moved["missed"] == 0.0 and moved["extra"] == 0.0
    assert abs(moved["det_gap"] - 0.5) < 1e-6
    assert detection_gaps([(box[:0], torch.zeros(0), torch.zeros(0))], ref)["missed"] == 1.0


def _conf_above_the_scores(name):
    """The cell cut down with a conf of 0.34, which most of the top
    candidates lie below: at 64 px the seeded weights score every row
    0.26-0.35, so that the cell's own conf (0.001) keeps every top candidate,
    and a threshold left out would change nothing."""
    c = small_cell(name)
    c["traffic"][c["traffic"]["kind"]]["conf"] = 0.34
    return c


@pytest.mark.parametrize("name,fault", [
    ("yolov7.detect.val", "altered_answer"),
    ("yolov7.detect.val", "no_suppression"),
    ("yolov7.detect.val", "conf_ignored"),
    ("yolov7.train.stager", "unchanged_step"),
    ("yolov7.train.stager", "half_batch"),
    ("yolov7.train.stager", "augment_altered"),
    ("yolov7-tiny.train.pool", "unchanged_step"),
    ("yolov7-tiny.train.pool", "half_batch"),
])
def test_a_planted_fault_is_not_correct(name, fault):
    cell = _conf_above_the_scores(name) if fault == "conf_ignored" else small_cell(name)
    out = controls.run_one(name, fault, SEED, 0.5, "cpu", cell)
    assert not out["correct"], json.dumps(out)
