"""The training driver: a traffic mix of kind ``train``.

Set-up writes the mix's seeded JPEGs to a directory under ``TMPDIR``, builds
one ``Trainer`` from a plan of the configuration and the mix, loads weights
drawn on the device from the seed, and drives its first three steps through
the same loop as the window (the first captures the step and the
augmentation). The window then drives the body of ``Trainer._epochs``
through the Trainer's own calls, ``draw``, ``jitted_augment()`` and
``jitted_train_step()``, on batches from ``PrefetchLoader`` and the native
stager, or from the device pool, until ``--seconds`` have passed and the
card is done; no checkpoint and no validation. Afterwards the program is
freed and the plain reference works out the first three augmented batches
again, to judge the program's, and takes the first three steps on the
program's batches.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import common as C

JPEG_SALT = 0x6A7067
SETUP_STEPS = 3


class Loop:
    """``Trainer._epochs``' body, a step at a time, across epochs."""

    def __init__(self, trainer, plan, pool, rec: "C.Records"):
        from yolo_continuous_tpu_torch.data.dataset import (PrefetchLoader, YoloDataset,
                                                            load_annotation_file)
        from yolo_continuous_tpu_torch.ops.augment import to_device
        from yolo_continuous_tpu_torch.ops.schedules import LRSchedule
        self.t, self.plan, self.rec = trainer, plan, rec
        self.Prefetch = PrefetchLoader
        self.ds = YoloDataset(
            load_annotation_file(plan.train_indexes), plan.image_size, plan.max_boxes,
            plan.mosaic, plan.mixup, plan.mosaic_prob, plan.mixup_prob, plan.epochs,
            plan.special_aug_ratio, train=True, seed=plan.seed, use_native=True,
            device=trainer.device)
        self.steps_per_epoch = max(len(self.ds) // plan.batch_size, 1)
        self.sched = LRSchedule(plan.learn_initial, plan.learn_final, plan.epochs, plan.decay,
                                plan.momentum, plan.warmup, plan.warmup_epochs,
                                plan.warmup_max_iter, plan.warmup_momentum,
                                plan.warmup_bias_lr, self.steps_per_epoch)
        self.pool = None
        if pool:
            self.pool = tuple(to_device(a, trainer.device) for a in self.ds.staged_pool())
        self.train_step, self.augment = trainer.jitted_train_step(), trainer.jitted_augment()
        self.host_step, self.epoch, self.batches, self.losses = 0, -1, None, []
        self.epoch_losses = []

    def _next_epoch(self):
        if self.losses:       # one host sync an epoch, as Trainer._epochs
            self.epoch_losses.append(float(torch.stack(self.losses).mean()))
            self.losses = []
        self.epoch += 1
        self.ds.reseed(self.epoch)
        p, t = self.plan, self.t
        if self.pool is not None:
            self.batches = iter(self.ds.epoch_plans(p.batch_size, p.shuffle, p.drop_last))
        else:
            self.batches = iter(map(t._ready, self.Prefetch(lambda: t._staged_batches(self.ds))))

    def step(self, state, record: bool = True):
        rec = self.rec
        with rec.span("data_wait"):
            batch = next(self.batches, None) if self.batches is not None else None
            while batch is None:
                self._next_epoch()
                batch = next(self.batches, None)
        hyper = self.sched(self.host_step)
        a = rec.mark()
        with rec.span("augment"):
            draw = self.t.draw(self.host_step, batch[0].shape[1], *batch[-2:])
            images, labels, lmask = self.augment(draw, batch, True, pool=self.pool)
        b = rec.mark()
        with rec.span("train_step"):
            state, metrics = self.train_step(state, images, labels, lmask, hyper.lr_weights,
                                             hyper.lr_bias, hyper.momentum)
        c = rec.mark()
        if record:
            rec.pair("augment", a, b)
            rec.pair("train_step", b, c)
        self.losses.append(metrics["loss"])
        self.host_step += 1
        return state, metrics, (images, labels, lmask)


def run(c: dict, seed: int, seconds: float, trace: bool, device, tmp: str, t_start: float,
        faults=None) -> dict:
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    from reference.compare import norms
    from reference.model import state_shapes
    cfg, mix = c["config"], c["traffic"]
    tr = mix["train"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    datas, boxes = C.jpegs(tr["images"], seed, tr["width"], tr["height"], JPEG_SALT)
    ann = C.write_dataset(tmp, datas, boxes)
    t_jpegs = time.perf_counter()
    plan = TrainPlan(C.plan_dict(
        cfg, ann, tmp, seed, batch_size=tr["batch"], epochs=tr["epochs"],
        max_boxes=tr["max_boxes"], enhance_cfg=tr["enhance"], device_cache=tr["device_cache"],
        **{k: tr[k] for k in ("lrI", "lrF", "decay", "momentum", "weight_decay", "warmup",
                              "focal_gamma", "focal_alpha", "anchor_t")}))
    trainer = Trainer(plan, device=dev)
    weights = C.make_weights(state_shapes(cfg), seed, dev)
    state = trainer.init_state(state_dict=weights)
    named = dict(state["model"].named_parameters())
    start = {k: v.detach().clone() for k, v in named.items()}
    ema0 = {k: v.clone() for k, v in state["ema"].tree.items()}
    rec = C.Records(cuda)
    loop = Loop(trainer, plan, tr["device_cache"], rec)
    if faults and "loop" in faults:
        faults["loop"](loop)
    t_built = time.perf_counter()

    # the first steps, through the window's own loop: the first captures
    prog = {"loss": [], "batches": []}
    for i in range(SETUP_STEPS):
        state, metrics, aug = loop.step(state, record=False)
        prog["loss"].append(metrics["loss"])
        prog["batches"].append(tuple(t.detach().to("cpu", copy=True) for t in aug))
        if i == 0:
            bufs = state["opt"].state
            # SGD's buffer after one step from zeros is the gradient it took
            prog["grad"] = norms({k: bufs[p]["momentum_buffer"] for k, p in named.items()})
    prog["change"] = norms({k: named[k].detach() - start[k] for k in named})
    prog["ema"] = norms({k: v - ema0[k] for k, v in state["ema"].tree.items()})
    prog["loss"] = [float(v) for v in prog["loss"]]
    del start, ema0
    if cuda:
        torch.cuda.synchronize()

    t_steps = time.perf_counter()
    tracer = C.Tracer(trace, seconds, cuda)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    print(f"[setup] {setup_s:.2f} s: to the images {t_jpegs - t_start:.2f}, the program "
          f"{t_built - t_jpegs:.2f}, the first {SETUP_STEPS} steps {t_steps - t_built:.2f}, "
          f"the profiler {t0 - t_steps:.2f}", file=sys.stderr)
    steps = 0
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
        tracer.maybe_start(elapsed)
        state, _, _ = loop.step(state)
        steps += 1
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    finite = all(np.isfinite(loop.epoch_losses + [float(v) for v in loop.losses]))
    traced = tracer.summary()
    ctx = {"window_s": window_s, "items": steps * tr["batch"], "steps": steps,
           "spans": rec.spans, "events": rec.events(), "trace": traced,
           "counts": counts(cfg, tr)}
    # the program goes before the reference runs
    del state, trainer, loop, named, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = compare(cfg, tr, seed, datas, boxes, weights, prog, dev)
    checks["loss_finite"] = 0.0 if finite else 1.0
    return {"setup_s": setup_s, "ctx": ctx, "checks": checks, "peak": peak,
            "attempted": steps * tr["batch"], "failed": 0,
            "e2e": {"train_img_s": steps * tr["batch"] / window_s}}


def counts(cfg: dict, tr: dict) -> dict:
    from .counts import forward_flops, stage_letterbox_bytes
    return {"forward_flops": forward_flops(cfg),
            "stage_letterbox_bytes": stage_letterbox_bytes(
                tr["batch"] * 4, tr["width"], tr["height"], cfg["image_size"])}


def compare(cfg, tr, seed, datas, boxes, weights, prog, dev) -> dict:
    """The program's first steps against the plain reference's, which takes
    its steps on the program's augmented batches and works out its own to
    judge them."""
    from reference.train import run_steps
    return numbers(prog, run_steps(cfg, tr, seed, datas, boxes, weights, SETUP_STEPS, dev,
                                   body_dtype=C.body_dtype(dev), batches=prog["batches"]),
                   weights)


def summary(ref: dict, weights: dict) -> dict:
    """A reference run (``reference.train.run_steps``) in the form the
    program's first steps are recorded: norms by leaf."""
    from reference.compare import norms
    return {"loss": ref["loss"], "batches": ref["augmented"],
            "grad": norms(ref["grad"]),
            "change": norms({k: v - weights[k].to(v.device) for k, v in ref["params"].items()}),
            "ema": norms({k: v - weights[k].to(v.device) for k, v in ref["ema"].items()})}


def numbers(prog: dict, ref: dict, weights: dict) -> dict:
    """What decides ``correct`` for a training cell: each step's augmented
    batch (the share of pixel values off by more than a grey level, the
    labels, the masks), each step's loss, and the gaps of norms of the first
    gradient, of the weights' change and of the EMA's change after the
    steps, by the worst leaf and by the median leaf (leaves that the
    reference's gradient leaves still are not compared in the changes).
    The worst leaves go to standard error."""
    from reference.compare import leaf_gaps, moving_leaves, worst_leaves
    r = summary(ref, weights)
    img_off = img_gap = lab_gap = mask_diff = 0.0
    for (p_img, p_lab, p_mask), (r_img, r_lab, r_mask) in zip(prog["batches"], r["batches"]):
        # the share of pixel values more than a grey level apart: the widest
        # gap is no measure, since the HSV gain's hue (multiplied, modulo
        # 180) jumps where a red pixel's green and blue tie to rounding
        gap = (p_img - r_img).abs()
        img_off = max(img_off, float((gap > 1.0 / 255.0).double().mean()))
        img_gap = max(img_gap, float(gap.max()))
        both = p_mask & r_mask
        if both.any():
            lab_gap = max(lab_gap, float((p_lab - r_lab).abs()[both].max()))
        mask_diff += float((p_mask != r_mask).sum())
    moving = moving_leaves(r["grad"])
    still = set(r["grad"]) - set(moving)
    for what, keys in (("grad", None), ("change", moving)):
        for row in worst_leaves(prog[what], r[what], keys, 4):
            print(f"[train] {what} gap {row[0]:.4g} {row[1]} program {row[2]:.6g} "
                  f"reference {row[3]:.6g}", file=sys.stderr)
    print(f"[train] losses program {prog['loss']} reference {r['loss']}; {len(still)} leaves "
          "left still by the reference's gradient", file=sys.stderr)
    out = {"aug_image_off": img_off, "aug_image_gap": img_gap, "aug_label_gap": lab_gap,
           "aug_mask_diff": mask_diff,
           "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], r["loss"])),
           "loss_gap_first": abs(prog["loss"][0] - r["loss"][0]) / abs(r["loss"][0])}
    for what, keys in (("grad", None), ("change", moving),
                       ("ema", [k for k in r["ema"] if k not in still])):
        gaps = leaf_gaps(prog[what], r[what], keys)
        out[f"{what}_gap"], out[f"{what}_gap_median"] = max(gaps), float(np.median(gaps))
    return out
