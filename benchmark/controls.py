"""The controls and the planted faults that ``correct`` has to catch.

Usage, from the root of a checkout on the card:
    python3 benchmark/controls.py --workload <name> --seeds 1,2,3 [--seconds S]
        [--what sound,control,fault_name,...]

- The control: the nearest precision below the configuration's bf16 body.
  Detection cells run the program with its own int8 path
  switched on (``Detector(quantize=True)``, calibrated on the cell's first
  batch); training cells put the plain reference, its convolutions in
  float8 e4m3, in the program's place and judge it against the reference.
- The faults, planted in the timed path: a train step that leaves its state
  unchanged, a train step on half of the batch (the mean over the rest),
  an augmented batch altered where it is produced, an answer altered
  where the request produces it, and the request's NMS suppressing nothing
  or keeping every score.

``sound`` runs the program as the benchmark does, for the readings that a
limit's lower end is set from. Each run prints one JSON line: the workload,
what was planted, the seed, ``correct``, every number computed, and each compared one beside
its limit.
The benchmark's own runs plant nothing.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def int8_detector(det, weights, calib):
    """The program's int8 path in place of its bf16 one: the same weights,
    calibrated on the cell's first batch."""
    from yolo_continuous_tpu_torch.detect_api import Detector
    q = Detector(det.plan, device=det.device, state_dict={k: v for k, v in weights.items()},
                 quantize=True)
    q.calibrate(calib.to(det.device))
    return q


class _Altered:
    """A Detector whose answers are altered where the request produces them:
    the best detection of every image moves by a tenth of its size and its
    score halves."""

    def __init__(self, det):
        self._det = det

    def __getattr__(self, name):
        return getattr(self._det, name)

    def __call__(self, images, *a, **k):
        import torch
        boxes, scores, classes, valid = self._det(images, *a, **k)
        boxes, scores = boxes.clone(), scores.clone()
        wh = (boxes[:, 0, 2:] - boxes[:, 0, :2]).repeat(1, 2)
        boxes[:, 0] = boxes[:, 0] + 0.1 * wh
        scores[:, 0] = scores[:, 0] * 0.5
        return boxes, scores, classes, torch.as_tensor(valid)


def altered_answer(det, weights, calib):
    return _Altered(det)


class _NmsFault:
    """A Detector whose request captures a broken NMS: the port's ``nms_core``
    with the IoU threshold above any IoU (nothing suppressed) or the score
    threshold at 0 (every candidate kept), in the timed path."""

    def __init__(self, det, conf=None, iou=None):
        self._det, self._conf, self._iou = det, conf, iou

    def __getattr__(self, name):
        return getattr(self._det, name)

    def __call__(self, images, conf_thres=0.5, nms_thres=0.4, max_det=300):
        from yolo_continuous_tpu_torch import detect_api
        real = detect_api.nms_core

        def broken(pred, conf, iou, k, *a):
            return real(pred, conf if self._conf is None else self._conf,
                        iou if self._iou is None else self._iou, k, *a)
        detect_api.nms_core = broken
        try:
            return self._det(images, conf_thres, nms_thres, max_det)
        finally:
            detect_api.nms_core = real


def no_suppression(det, weights, calib):
    return _NmsFault(det, iou=2.0)


def conf_ignored(det, weights, calib):
    return _NmsFault(det, conf=0.0)


def unchanged_step(loop):
    """The train step returns its state unchanged (its loss still reported)."""
    trainer = loop.t

    def step(state, images, labels, lmask, *hyper):
        return state, {"loss": trainer.eval_loss(state, images, labels, lmask)}
    loop.train_step = step


def half_batch(loop):
    """The train step sees half of the batch: the mean is over the rest."""
    real = loop.train_step

    def step(state, images, labels, lmask, *hyper):
        h = images.shape[0] // 2
        return real(state, images[:h], labels[:h], lmask[:h], *hyper)
    loop.train_step = step


def augment_altered(loop):
    """The augmentation's answer altered where it is produced: the first
    sample mirrored left to right with its boxes, and its last box dropped."""
    import torch
    real = loop.augment

    def augment(draw, batch, train=True, pool=None):
        images, labels, lmask = (t.clone() for t in real(draw, batch, train, pool=pool))
        images[0] = images[0].flip(1)
        labels[0, :, 1] = torch.where(lmask[0], 1.0 - labels[0, :, 1], labels[0, :, 1])
        n = int(lmask[0].sum())
        if n:
            lmask[0, n - 1] = False
            labels[0, n - 1] = 0.0
        return images, labels, lmask
    loop.augment = augment


DETECTOR_FAULTS = {"altered_answer": {"detector": altered_answer},
                   "no_suppression": {"detector": no_suppression},
                   "conf_ignored": {"detector": conf_ignored}}
FAULTS = {"detect": DETECTOR_FAULTS,
          "train": {"unchanged_step": {"loop": unchanged_step},
                    "half_batch": {"loop": half_batch},
                    "augment_altered": {"loop": augment_altered}}}


def train_control(cell: dict, seed: int, device="cuda") -> dict:
    """The fp8 reference in the program's place, judged against the
    reference: the numbers a training cell compares."""
    import torch
    from harness import common as C
    from harness.train import JPEG_SALT, SETUP_STEPS, numbers, summary
    from reference.model import state_shapes
    from reference.train import run_steps
    cfg, tr = cell["config"], cell["traffic"]["train"]
    datas, boxes = C.jpegs(tr["images"], seed, tr["width"], tr["height"], JPEG_SALT)
    weights = C.make_weights(state_shapes(cfg), seed, device)
    body = C.body_dtype(device)
    low = summary(run_steps(cfg, tr, seed, datas, boxes, weights, SETUP_STEPS, device,
                            fp8=True, body_dtype=body), weights)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = run_steps(cfg, tr, seed, datas, boxes, weights, SETUP_STEPS, device, body_dtype=body,
                    batches=low["batches"])
    out = numbers(low, ref, weights)
    out["loss_finite"] = 0.0 if all(math.isfinite(v) for v in low["loss"]) else 1.0
    return out


def judged(cell: dict, checks: dict) -> dict:
    out = {k: {"value": float(checks.get(k, float("inf"))), "limit": float(v)}
           for k, v in cell["limits"].items()}
    return {"correct": all(c["value"] <= c["limit"] for c in out.values()), "checks": out}


def run_one(name: str, what: str, seed: int, seconds: float, device="cuda", cell=None) -> dict:
    import run
    from harness import common as C
    bench = C.benchmark_json()
    cell = cell or C.cell(name, bench)
    kind = cell["traffic"]["kind"]
    numbers = {}
    if what == "control" and kind == "train":
        numbers = train_control(cell, seed, device)
        res = judged(cell, numbers)
    else:
        faults = ({"detector": int8_detector} if what == "control"
                  else None if what == "sound" else FAULTS[kind][what])
        res = run.execute(name, seed, seconds, False, device, bench, cell, faults=faults,
                          t_start=time.perf_counter(), numbers=numbers)
    return {"workload": name, "planted": what, "seed": seed, "correct": res["correct"],
            "numbers": numbers, "checks": res["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--what", default="control")
    a = ap.parse_args(argv)
    import run
    run.caches()
    for what in a.what.split(","):
        for seed in (int(s) for s in a.seeds.split(",")):
            print(json.dumps(run_one(a.workload, what, seed, a.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
