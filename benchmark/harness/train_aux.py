"""The training driver of a net with auxiliary heads: a traffic mix of kind
``train_aux``.

As ``train.py``, whose ``Loop`` (the window's loop over ``Trainer._epochs``'
body: ``draw``, ``jitted_augment()``, ``jitted_train_step()`` on batches
from ``PrefetchLoader`` and the native stager) and ``numbers`` it reuses,
with the plain reference of a P6 net with ``IAuxDetect`` in place of the P5
one (``reference/p6_model.py``, ``aux_loss.py``, ``p6_train.py``). The
weights are drawn as ``common.make_weights`` draws them, and the implicit
rows as upstream initialises them: ``ImplicitA`` N(0, 0.02^2), ``ImplicitM``
N(1, 0.02^2). Besides ``train.numbers``, ``correct`` compares the first
step's lead and auxiliary positives (``num_fg``, ``num_fg_aux``) with the
reference's. A traced run also keeps the port's phase marks of the window
(``harness/marks.py``) as ``marks`` for the readers.

The cell needs the port's auxiliary counter and mark (``num_fg_aux``,
``step_aux``): a port without them is refused before any work.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import common as C
from . import marks as M
from .train import JPEG_SALT, SETUP_STEPS, Loop, numbers, summary

IMPLICIT_SALT = 0x696D70


def needs_aux_counter() -> None:
    from yolo_continuous_tpu_torch.utils import trace
    if "step_aux" not in trace.MARKS:
        raise SystemExit("this port has no step_aux mark and no num_fg_aux counter: the "
                         "train_aux driver cannot judge its auxiliary heads")


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """``common.make_weights`` over the reference's state dict, with the
    implicit rows redrawn from the seed: ``ImplicitA`` N(0, 0.02^2),
    ``ImplicitM`` N(1, 0.02^2) (upstream ``models/common.py``)."""
    from reference.p6_model import state_shapes
    shapes = state_shapes(cfg)
    w = C.make_weights(shapes, seed, device)
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) ^ IMPLICIT_SALT) & 0xFFFFFFFFFFFFFFFF)
    for k, s, _ in shapes:
        if k.endswith(".implicit"):
            mean = 1.0 if ".im." in k else 0.0
            w[k] = mean + 0.02 * torch.randn(s, generator=gen, device=device)
    return w


def closable_loaders(loop) -> list:
    """Make the loop's ``PrefetchLoader`` keep each epoch's iterator in the
    returned list. Closing an iterator stops its thread; one left open keeps
    the thread waiting to hand over its next batch, and through it the
    Trainer and its graphs alive."""
    iters = []

    class Prefetch(loop.Prefetch):
        def __iter__(self):
            it = super().__iter__()
            iters.append(it)
            return it
    loop.Prefetch = Prefetch
    return iters


def run(c: dict, seed: int, seconds: float, trace: bool, device, tmp: str, t_start: float,
        faults=None) -> dict:
    needs_aux_counter()
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    from reference.compare import norms
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
    weights = draw_weights(cfg, seed, dev)
    state = trainer.init_state(state_dict=weights)
    named = dict(state["model"].named_parameters())
    start = {k: v.detach().clone() for k, v in named.items()}
    ema0 = {k: v.clone() for k, v in state["ema"].tree.items()}
    rec = C.Records(cuda)
    loop = Loop(trainer, plan, tr["device_cache"], rec)
    loaders = closable_loaders(loop)
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
            prog["fg"] = [int(metrics[k]) for k in ("num_fg", "num_fg_aux")]
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
           "marks": M.device_marks(tracer.prof) if tracer.prof is not None else [],
           "counts": counts(cfg, tr)}
    # the program goes before the reference runs: the prefetch threads stop
    # (an open one holds the Trainer), then the graphs go with their pools
    for it in loaders:
        it.close()
    trainer._drop_graphs()
    del state, trainer, loop, named, rec, tracer, metrics, aug, bufs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        print(f"[reference] the card holds {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
              f"({torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved) as it starts",
              file=sys.stderr)
    t_ref = time.perf_counter()
    checks = compare(cfg, tr, seed, datas, boxes, weights, prog, dev)
    checks["loss_finite"] = 0.0 if finite else 1.0
    print(f"[reference] {time.perf_counter() - t_ref:.2f} s after the window", file=sys.stderr)
    return {"setup_s": setup_s, "ctx": ctx, "checks": checks, "peak": peak,
            "attempted": steps * tr["batch"], "failed": 0,
            "e2e": {"train_img_s": steps * tr["batch"] / window_s}}


def counts(cfg: dict, tr: dict) -> dict:
    """The training form's forward FLOPs (lead and auxiliary heads) an image,
    and the stager's bytes a batch."""
    from reference.p6_model import forward_flops
    from .counts import stage_letterbox_bytes
    return {"forward_flops": forward_flops(cfg),
            "stage_letterbox_bytes": stage_letterbox_bytes(
                tr["batch"] * 4, tr["width"], tr["height"], cfg["image_size"])}


def fg_gaps(prog_fg, ref: dict) -> dict:
    """The relative gaps of the first step's lead and auxiliary positives."""
    out = {}
    for name, p, r in (("fg_gap_first", prog_fg[0], ref["num_fg"][0]),
                       ("fg_aux_gap_first", prog_fg[1], ref["num_fg_aux"][0])):
        out[name] = abs(p - r) / max(r, 1)
    print(f"[train] first step's positives program {prog_fg} reference "
          f"{[ref['num_fg'][0], ref['num_fg_aux'][0]]}", file=sys.stderr)
    return out


def compare(cfg, tr, seed, datas, boxes, weights, prog, dev) -> dict:
    """The program's first steps against the plain reference's, which takes
    its steps on the program's augmented batches and works out its own to
    judge them."""
    from reference.p6_train import run_steps
    ref = run_steps(cfg, tr, seed, datas, boxes, weights, SETUP_STEPS, dev,
                    body_dtype=C.body_dtype(dev), batches=prog["batches"])
    return {**numbers(prog, ref, weights), **fg_gaps(prog["fg"], ref)}


def control(cell: dict, seed: int, device="cuda") -> dict:
    """The fp8 reference in the program's place, judged against the
    reference: the numbers this cell compares."""
    import math
    from reference.p6_train import run_steps
    cfg, tr = cell["config"], cell["traffic"]["train"]
    datas, boxes = C.jpegs(tr["images"], seed, tr["width"], tr["height"], JPEG_SALT)
    weights = draw_weights(cfg, seed, device)
    body = C.body_dtype(device)
    raw = run_steps(cfg, tr, seed, datas, boxes, weights, SETUP_STEPS, device, fp8=True,
                    body_dtype=body)
    low = summary(raw, weights)
    fg = [raw["num_fg"][0], raw["num_fg_aux"][0]]
    del raw
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = run_steps(cfg, tr, seed, datas, boxes, weights, SETUP_STEPS, device, body_dtype=body,
                    batches=low["batches"])
    out = {**numbers(low, ref, weights), **fg_gaps(fg, ref)}
    out["loss_finite"] = 0.0 if all(math.isfinite(v) for v in low["loss"]) else 1.0
    return out
