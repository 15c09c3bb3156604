#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the root of a checkout, one card

It imports only ``torch``, numpy and the port package
``yolo_continuous_tpu_torch`` (nothing of JAX), and runs in phases; any
failure exits non-zero before the result line.

1. build: compiles the port's CUDA kernels (``csrc/*.cu``, one ``nvcc``
   each, in parallel) and prints the seconds and the ptxas report.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the main paths: K3 decode on the three yolov7 @640 levels
   at batch 16, in its TMA form (one launch for all levels), held bit-equal
   to its strided form and timed beside it; K1 NMS at K = 300 x 16 images,
   also timed at 300 x 1 and 1024 x 16 beside an empty kernel launched as
   K1 is (the launch floor); K2 NMS at K = 2048, 4096, 8192 and at a
   640 px plan's 25,200 candidates (against the plain version run class by
   class, exact as the keep-set is the union of the classes' keep-sets)
   (NMS inputs are 25200 random candidates per image cut to the top K, as
   the JAX bench builds them, plus a chained-overlap case; keep-sets must
   be identical); K4 IBin decode on the three yolov7-IBin @640 levels at
   batch 16, under the argmax-gap precondition, its two forms as K3's; K5 fused 1x1 conv + BN +
   SiLU in bf16 at each of the 24 shapes that yolov7 @640 gives it at
   batch 16, plus fp32 and ragged cases. K5 is also timed against cuDNN's
   bf16 ``F.conv2d`` of the same products and the port's unfused ``Conv``.
3. reference: ``Detector``s on CUDA in fp32 against the same seeded
   ``Detector``s on the CPU (plain versions) at 64 px: yolov7 (raw maps,
   decoded rows, NMS keep-set of the kernel equal to the plain one on the
   same rows), yolov7-IBin (the same, K4 rows), ``cfg/net/yolov7-aux.yaml``
   (all six maps) and yolov7 with ``fused_tails=True`` (maps, through K5).
4. main paths, each on ``cfg/coco_train.yaml`` (80 classes, 640 px), seeded
   random weights, bf16 body, batch 16, conf 0.25, IoU 0.45:
   (default) yolov7 with the Detect head, a few requests at max_det 300 and
   one at 4096 (which takes K2); (ibin) yolov7 with the head row swapped to
   IBin; (fused_tails) yolov7 with ``Detector(fused_tails=True)``. Launch
   counters are set to 0 just before each path and read just after; every
   kernel of the path must have launched (K3 or K4 once a request, in the
   TMA form, and K5 24 times a request). Each path prints its stage times
   from CUDA events (the NMS stage also split into ``top_candidates`` and
   ``suppress`` device time) and a short
   profiler window; the default and fused-tail paths also the host's
   enqueue time. Then the three paths' forward and request times, measured
   in turns.
5. train: the train step (``train/train_loop.Trainer.train_step``: forward,
   SimOTA loss, backward, 3-group SGD-Nesterov, EMA) of yolov7 @640
   (``cfg/coco_train.yaml``, 80 classes) at batch 16, max_boxes 64, bf16
   body on fp32 master weights, images from ``RandomState(0)`` and two
   labels an image (the JAX bench's train section, ``bench.py:105-155``),
   lr_w, lr_b, mom = 0.01, 0.1, 0.937: one warm-up step, then 10 timed
   steps; it prints step ms, img/s, peak memory, launches a step
   (profiler), host enqueue ms a step, the loss parts and ``num_fg``, and
   fails unless every loss is finite, ``num_fg > 0``, the parameters and
   the EMA moved and a checkpoint saved on the card loads back bit-equal.
   Then one step of yolov7-tiny @128, batch 2, fp32, on the card and on the
   CPU from the same weights: loss parts, ``num_fg``, gradients and updated
   parameters must agree within the CPU parity tests' tolerances
   (``tests/test_torch_port_train.py``).

Kernel times are device times: ``cuda_ms`` holds the stream with a sleep
kernel while the host enqueues the timed calls, so that a kernel shorter
than its wrapper's host time is not timed at the host's pace.

Before the last line it prints the ``kernels`` JSON line (time, bound,
launches, error of each kernel) and the card's name and power limit; the
last line is ``{"ok": true, "device": {...}}``.
"""
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor and bf16
# dense tensor-core flop/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
IOU_OPS = 13        # fp32 operations of one IoU test (4 min/max, 4 sub, 2 clamp, mul, add, div)
DECODE_TOL = 1e-5   # K3/K4 vs plain, normalized rows: expf vs torch.exp differ by ulps
BIN_GAP = 1e-5      # K4 precondition: top two sigmoided bins of every value this far apart
# K5 vs plain: bf16 within one bf16 ulp (fp32 sums in another order can round
# across a bf16 boundary); fp32 within fp32 summation-order error
K5_TOL = {"bf16": dict(rtol=8e-3, atol=1e-3), "fp32": dict(rtol=1e-5, atol=1e-4)}
BS, SIZE, CONF, IOU = 16, 640, 0.25, 0.45
# one train step, card against CPU (fp32): the tolerances of
# tests/test_torch_port_train.py, set by the summation order of train-mode
# BN statistics amplified with depth (PERF.md)
STEP_LOSS_RTOL = 1e-3        # loss, box, obj, cls
STEP_REL_L2 = 3e-2           # gradients, updates: |got - want|_2 / |want|_2 over all tensors


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, hold: bool = True) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls (CUDA events).
    With ``hold`` (kernels) the stream first waits on a sleep kernel long
    enough for the host to enqueue every call, so the calls run back to back
    at the card's pace; without it (requests) the host sets the pace, as it
    does for a user."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if hold:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0           # one call, host and card together
        torch.cuda._sleep(int(min(2e9, 3e9 * host_s * iters + 2e5)))   # cycles at about 2 GHz
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nms_inputs(rs, k: int, bs: int):
    """Top-k candidates of ``bs`` images of 25200 random predictions, built
    like the JAX bench's NMS section (bench.py:237-240)."""
    import torch
    from yolo_continuous_tpu_torch.ops.nms import top_candidates
    pred = torch.from_numpy(rs.rand(bs, 25200, 85).astype("float32"))
    pred[..., 2:4] = pred[..., 2:4] * 0.1 + 0.01
    boxes, _, classes, valid = top_candidates(pred.cuda(), CONF, k)
    return boxes.contiguous(), classes, valid


def dense_inputs(rs, k: int, bs: int):
    """k large boxes of 3 classes per image, sorted by a random score: many
    overlaps, so suppression does real work."""
    import torch
    cxy = rs.rand(bs, k, 2)
    wh = rs.rand(bs, k, 2) * 0.3 + 0.02
    boxes = torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype("float32"))
    classes = torch.from_numpy(rs.randint(0, 3, (bs, k)).astype("int32"))
    return boxes.cuda(), classes.cuda(), torch.ones(bs, k, dtype=torch.bool, device="cuda")


def chain_inputs(k: int):
    """k boxes of one class, each overlapping the next at IoU 7/13 and the
    one after at 1/4: greedy keeps every other one, and the fixpoint needs
    about k sweeps."""
    import torch
    x = torch.arange(k, dtype=torch.float32) * 3.0
    boxes = torch.stack([x, torch.zeros(k), x + 10.0, torch.full((k,), 10.0)], -1)
    return (boxes[None].cuda(), torch.zeros(1, k, dtype=torch.int32, device="cuda"),
            torch.ones(1, k, dtype=torch.bool, device="cuda"))


def ibin_maps(g, spec):
    """Random raw IBin maps at the main path's shapes, as the head gives
    them (strided views of NCHW outputs), with one random bin of every w/h
    value raised a logit above the others (the argmax-gap precondition)."""
    import torch
    from yolo_continuous_tpu_torch.nn.heads import head_view
    na, nb = spec.na, spec.bin_count
    n = nb + 1
    no = spec.nc + 3 + 2 * n
    maps = []
    for s in spec.strides:
        side = SIZE // s
        p = torch.randn(BS, side, side, na, no, device="cuda", generator=g) * 2.0
        for off in (3, 3 + n):
            bins = p[..., off:off + nb].clamp(-3.0, 3.0)
            win = torch.randint(0, nb, (BS, side, side, na, 1), device="cuda", generator=g)
            bins.scatter_(-1, win, bins.amax(-1, keepdim=True) + 1.0)
            p[..., off:off + nb] = bins
        nchw = p.permute(0, 3, 4, 1, 2).reshape(BS, na * no, side, side).contiguous()
        maps.append(head_view(nchw, na, no))
    return maps


def min_bin_gap(maps, nbin: int) -> float:
    """Smallest gap between the top two sigmoided bins of any w/h value."""
    import torch
    gap = float("inf")
    for m in maps:
        s = torch.sigmoid(m.double())
        for off in (3, 3 + nbin + 1):
            top2 = s[..., off:off + nbin].topk(2, dim=-1).values
            gap = min(gap, (top2[..., 0] - top2[..., 1]).min().item())
    return gap


def fused_tail_shapes():
    """(C_in, C_out, H, W) of every K5 call of one yolov7 @640 fused-tail
    request at batch 16, in call order, read off a forward on the card;
    each call must take the wgmma + TMA form (``form_for``)."""
    import torch
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.kernels.fused_conv import form_for
    from yolo_continuous_tpu_torch.nn import layers
    shapes, forms, fn = [], [], layers.fused_pointwise_conv

    def record(x, w, scale, bias):
        shapes.append((x.shape[1], w.shape[0], x.shape[2], x.shape[3]))
        forms.append(form_for(x, w))
        return fn(x, w, scale, bias)

    det = Detector(random_weights_plan(), device="cuda", seed=0, fused_tails=True)
    layers.fused_pointwise_conv = record
    try:
        with torch.inference_mode():
            det.forward(torch.zeros(BS, SIZE, SIZE, 3, device="cuda"))
    finally:
        layers.fused_pointwise_conv = fn
    torch.cuda.synchronize()
    if set(forms) != {"wgmma"}:
        fail(f"yolov7 @640 fused tails: K5 forms {forms}, every call must take wgmma")
    return shapes


def check_forms(what, kernel, maps) -> None:
    """The TMA form of a decode kernel (``kernel(normalized, form)``) on maps
    it must take: bit-equal to the strided form in both modes."""
    import torch
    for normalized in (True, False):
        tma, strided = kernel(normalized, "tma"), kernel(normalized, "strided")
        if not torch.equal(tma, strided):
            fail(f"{what} (normalized={normalized}): the TMA form differs from the strided form in "
                 f"{int((tma != strided).sum())} values")


def phase_kernels(spec, bin_spec, k5_shapes):
    """Each kernel against its plain version at main-path shapes."""
    import torch
    from yolo_continuous_tpu_torch.kernels.decode import form_for, launch_form
    from yolo_continuous_tpu_torch.kernels.nms import nms_suppress, nms_suppress_tiled
    from yolo_continuous_tpu_torch.nn.heads import head_view
    from yolo_continuous_tpu_torch.ops.decode import decode_level
    from yolo_continuous_tpu_torch.ops.nms import suppress_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    na, no = spec.na, spec.nc + 5
    sides = [SIZE // s for s in spec.strides]                     # P5, P4, P3
    maps = [head_view(torch.randn(BS, na * no, n, n, device="cuda", generator=g) * 3.0, na, no)
            for n in sides]

    def plain_decode(normalized=True):
        return torch.cat([decode_level(m, torch.tensor(a), float(s), normalized)
                          for m, a, s in zip(maps, spec.anchors, spec.strides)], 1)

    def kernel(normalized=True, form="tma"):
        return launch_form(maps, spec.anchors, spec.strides, normalized, form)

    if form_for(maps) != "tma":
        fail(f"K3 at yolov7 @640: the head maps take the {form_for(maps)} form, not tma")
    report = {}
    got = kernel(True)
    want = plain_decode(True)
    err = (got - want).abs().max().item()
    if not (got.shape == want.shape and err <= DECODE_TOL):
        fail(f"K3 decode: max abs err {err} > {DECODE_TOL} (shape {tuple(got.shape)})")
    px_got = kernel(False)
    if not torch.allclose(px_got, plain_decode(False), rtol=1e-5, atol=1e-4):
        fail("K3 decode (pixel mode) disagrees with the plain version")
    check_forms("K3 decode", kernel, maps)
    rows = got.shape[1]
    report["decode_level"] = dict(
        max_abs_err=err, ms=cuda_ms(kernel), strided_ms=cuda_ms(lambda: kernel(True, "strided")),
        plain_ms=cuda_ms(plain_decode),
        bound_ms=2 * BS * rows * no * 4 / HBM_BYTES_S * 1e3, bound_by="bytes", library_ms=None)
    print(f"K3 decode: {BS}x{rows}x{no} max_abs_err {err:.3g} (tol {DECODE_TOL}); TMA form "
          f"bit-equal to the strided form in both modes", flush=True)
    print(json.dumps({"decode_host_us_per_call": {
        form: host_us(lambda: kernel(True, form)) for form in ("tma", "strided")}}), flush=True)
    del maps, got, want, px_got

    rs = np.random.RandomState(0)
    rs1 = np.random.RandomState(1)          # K1's added cases; K2's inputs stay those of rs
    k1_shapes = {"300x16": nms_inputs(rs, 300, BS), "300x1": nms_inputs(rs1, 300, 1),
                 "1024x16": dense_inputs(rs1, 1024, BS)}
    chains = {k: chain_inputs(k) for k in (300, 1024, 2048)}
    cases = {"nms_suppress": [(300, k1_shapes["300x16"]), (300, dense_inputs(rs, 300, BS)),
                              (1024, dense_inputs(rs, 1024, 4)), (300, chains[300]),
                              (300, k1_shapes["300x1"]), (1024, k1_shapes["1024x16"]),
                              (1024, chains[1024])],
             "nms_suppress_tiled": [(4096, nms_inputs(rs, 4096, BS)),
                                    (2048, nms_inputs(rs, 2048, BS)),
                                    (4096, dense_inputs(rs, 4096, 4)),
                                    (8192, nms_inputs(rs, 8192, 4)),
                                    (8192, dense_inputs(rs, 8192, 4)),
                                    (2048, chains[2048])]}
    for name, fn in (("nms_suppress", nms_suppress), ("nms_suppress_tiled", nms_suppress_tiled)):
        err = 0.0
        for k, args in cases[name]:
            got = fn(*args, IOU)
            want = suppress_plain(*args, IOU)
            err = max(err, (got.float() - want.float()).abs().max().item())
            if not torch.equal(got, want):
                fail(f"{name} K={k}: keep-set differs from the plain version in "
                     f"{int((got != want).sum())} places")
            chain = args is chains.get(k)
            if chain and not torch.equal(got[0], torch.arange(k, device="cuda") % 2 == 0):
                fail(f"{name} K={k}: greedy keeps exactly every other box of the chain")
            print(f"{name}: K={k} x {args[0].shape[0]} keep-set equal "
                  f"({int(got.sum())} kept of {int(args[2].sum())} valid)", flush=True)
        k, args = cases[name][0]
        b = args[0].shape[0]
        report[name] = dict(
            max_abs_err=err, ms=cuda_ms(lambda: fn(*args, IOU)),
            plain_ms=cuda_ms(lambda: suppress_plain(*args, IOU), iters=5, warmup=1),
            **nms_bound(b, k), library_ms=None)
        print(f"{name}: timed at K={k} x {b} images", flush=True)
    shapes = k1_timed_shapes(k1_shapes)
    report["nms_suppress"].update(ms_300x1=shapes["300x1"]["ms"], ms_1024x16=shapes["1024x16"]["ms"],
                                  launch_floor_ms=shapes["300x16"]["launch_floor_ms"],
                                  host_us=shapes["300x16"]["host_us"])
    tiled_phases(*cases["nms_suppress_tiled"][0][1])
    report["nms_suppress_tiled"].update(check_k2_full(rs))

    report["decode_level_bin"] = check_bin_decode(g, bin_spec)
    report["fused_conv"] = check_fused_conv(g, k5_shapes)
    return report


def suppress_plain_by_class(boxes, classes, valid, thr):
    """The plain keep-set, class by class: the class-aware greedy keep-set is
    the union of each class's own, in score order, so this is exact, and its
    IoU matrices stay a class's size (a K x K one is 2.5 GB at 25,200)."""
    import torch
    from yolo_continuous_tpu_torch.ops.nms import suppress_plain
    keep = torch.zeros_like(valid)
    for b in range(boxes.shape[0]):
        for c in classes[b].unique():
            idx = (classes[b] == c).nonzero().squeeze(1)
            keep[b, idx] = suppress_plain(boxes[b, idx][None], classes[b, idx][None],
                                          valid[b, idx][None], thr)[0]
    return keep


def check_k2_full(rs) -> dict:
    """K2 at every candidate of a 640 px plan (K = 25,200, batch 2, 80
    classes): equal to the plain keep-set, and timed."""
    import torch
    from yolo_continuous_tpu_torch.kernels.nms import K2_MAX, k2_ring, nms_suppress_tiled
    k = 25200
    args = nms_inputs(rs, k, 2)
    got = nms_suppress_tiled(*args, IOU)
    want = suppress_plain_by_class(*args, IOU)
    if not torch.equal(got, want):
        fail(f"nms_suppress_tiled K={k}: keep-set differs from the plain version in "
             f"{int((got != want).sum())} places")
    ms = cuda_ms(lambda: nms_suppress_tiled(*args, IOU), iters=5)
    out = dict(k=k, batch=2, ring=k2_ring(k), k_max=K2_MAX, kept=int(got.sum()),
               valid=int(args[2].sum()), ms=ms, **nms_bound(2, k))
    print(json.dumps({"nms_suppress_tiled_full": out}), flush=True)
    return {"ms_25200x2": ms, "bound_ms_25200x2": out["bound_ms"]}


def nms_bound(b: int, k: int) -> dict:
    """Bound of a K1/K2 call: one IoU test a pair, as greedy needs, against
    the fp32 rate; boxes, classes and valid read, keep written."""
    ops = b * k * (k - 1) / 2 * IOU_OPS
    nbytes = b * k * (16 + 4 + 1 + 1)
    return dict(bound_ms=max(ops / FP32_FLOP_S, nbytes / HBM_BYTES_S) * 1e3,
                bound_by="operations" if ops / FP32_FLOP_S > nbytes / HBM_BYTES_S else "bytes")


def k1_timed_shapes(shapes: dict) -> dict:
    """K1 at each (label: inputs): device ms; the launch floor, an empty
    kernel launched as K1 is (grid, cluster, block, shared memory) through
    the same ``cuda_ms``; host us a call; the cluster size ``cluster_size``
    picks, and the time at every cluster size; the bound."""
    import torch
    from yolo_continuous_tpu_torch.kernels.nms import _launch, cluster_size, nms_suppress
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, args in shapes.items():
        b, k = args[0].shape[:2]
        c = cluster_size(b, k, sms)
        out[label] = dict(
            cluster=c, ms=cuda_ms(lambda: nms_suppress(*args, IOU)),
            launch_floor_ms=cuda_ms(lambda: _launch("nms_launch_floor", *args, IOU, cluster=c)),
            host_us=host_us(lambda: nms_suppress(*args, IOU)), **nms_bound(b, k),
            ms_by_cluster={n: cuda_ms(lambda: _launch("nms_suppress", *args, IOU, cluster=n))
                           for n in (1, 2, 4, 8)})
    print(json.dumps({"nms_suppress_shapes": out}), flush=True)
    return out


def tiled_phases(boxes, classes, valid) -> None:
    """K2's two launches timed apart (mask across all SMs, one-CTA-per-image
    sweep), on one scratch mask."""
    from yolo_continuous_tpu_torch.kernels.nms import _launch, tiled_scratch
    scratch = tiled_scratch(boxes)
    phases = {f"{fn.split('_')[-1]}_ms": cuda_ms(lambda: _launch(fn, boxes, classes, valid, IOU,
                                                                  scratch=scratch))
              for fn in ("nms_tiled_mask", "nms_tiled_sweep")}
    b, k = boxes.shape[:2]
    print(json.dumps({"nms_suppress_tiled_phases": dict(k=k, batch=b, **phases)}), flush=True)


def check_bin_decode(g, spec) -> dict:
    """K4 against decode_level_bin on the yolov7-IBin @640 levels, batch 16."""
    import torch
    from yolo_continuous_tpu_torch.kernels.bin_decode import form_for, launch_form
    from yolo_continuous_tpu_torch.ops.decode import decode_level_bin
    nb = spec.bin_count
    maps = ibin_maps(g, spec)
    gap = min_bin_gap(maps, nb)
    if not gap > BIN_GAP:
        fail(f"K4 inputs break the argmax-gap precondition: {gap} <= {BIN_GAP}")
    if form_for(maps, nb) != "tma":
        fail(f"K4 at yolov7-IBin @640: the head maps take the {form_for(maps, nb)} form, not tma")

    def kernel(normalized=True, form="tma"):
        return launch_form(maps, spec.anchors, spec.strides, nb, normalized, form)

    def plain(normalized=True):
        return torch.cat([decode_level_bin(m, torch.tensor(a), float(s), nb, normalized)
                          for m, a, s in zip(maps, spec.anchors, spec.strides)], 1)

    got, want = kernel(True), plain(True)
    err = (got - want).abs().max().item()
    if not (got.shape == want.shape and err <= DECODE_TOL):
        fail(f"K4 bin decode: max abs err {err} > {DECODE_TOL} (shape {tuple(got.shape)})")
    if not torch.allclose(kernel(False), plain(False), rtol=1e-5, atol=1e-4):
        fail("K4 bin decode (pixel mode) disagrees with the plain version")
    check_forms("K4 bin decode", kernel, maps)
    rows, no_in, no_out = got.shape[1], maps[0].shape[-1], got.shape[-1]
    print(f"K4 bin decode: {BS}x{rows}x{no_in} -> {no_out} max_abs_err {err:.3g} "
          f"(tol {DECODE_TOL}; min bin gap {gap:.3g}); TMA form bit-equal to the strided form "
          f"in both modes", flush=True)
    return dict(max_abs_err=err, ms=cuda_ms(kernel),
                strided_ms=cuda_ms(lambda: kernel(True, "strided")), plain_ms=cuda_ms(plain),
                bound_ms=BS * rows * (no_in + no_out) * 4 / HBM_BYTES_S * 1e3,
                bound_by="bytes", library_ms=None)


def k5_inputs(g, b, c, n, h, w, dtype):
    import torch
    x = torch.randn(b, c, h, w, device="cuda", generator=g).to(dtype)
    wt = (torch.randn(n, c, device="cuda", generator=g) / c ** 0.5).to(dtype)
    scale = torch.rand(n, device="cuda", generator=g) + 0.5
    bias = torch.randn(n, device="cuda", generator=g) * 0.1
    return x, wt, scale, bias


def k5_compare(args, tol) -> float:
    import torch
    from yolo_continuous_tpu_torch.kernels.fused_conv import (fused_pointwise_conv_cuda,
                                                              fused_pointwise_conv_plain)
    got = fused_pointwise_conv_cuda(*args)
    want = fused_pointwise_conv_plain(*args)
    shape = tuple(args[0].shape[:1]) + (args[1].shape[0],) + tuple(args[0].shape[2:])
    if got.dtype != args[0].dtype or tuple(got.shape) != shape:
        fail(f"K5: output {got.dtype} {tuple(got.shape)} for input {tuple(args[0].shape)}")
    if not torch.allclose(got.float(), want.float(), **tol):
        bad = ~torch.isclose(got.float(), want.float(), **tol)
        fail(f"K5 at {tuple(args[0].shape)} -> {args[1].shape[0]}: {int(bad.sum())} values "
             f"outside {tol}, max abs err {(got.float() - want.float()).abs().max().item()}")
    return (got.float() - want.float()).abs().max().item()


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds to enqueue one call, on an idle card."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def check_fused_conv(g, shapes) -> dict:
    """K5 against its plain version at every main-path shape (bf16, batch
    16), one fp32 case and ragged ones; each main-path call rerun for
    bit-equal outputs. Times the wgmma form beside the mma.sync form, cuDNN's
    bf16 conv and cuBLAS's batched matmul of the same products, and the
    port's unfused Conv."""
    import torch
    import torch.nn.functional as F
    from yolo_continuous_tpu_torch.kernels.fused_conv import (form_for, fused_pointwise_conv_cuda,
                                                              fused_pointwise_conv_plain,
                                                              launch_form, reciprocal_mismatches)
    from yolo_continuous_tpu_torch.nn.layers import Conv

    t0 = time.perf_counter()
    bad = reciprocal_mismatches("cuda")
    print(f"K5 epilogue: branch-free 1/d differs from __fdiv_rn(1, d) on {bad} of the floats "
          f"d in [1, 2^126) ({time.perf_counter() - t0:.2f} s)", flush=True)
    if bad:
        fail("K5: the wgmma form's epilogue does not round as bn_silu does")

    # ragged: C, N and HW off the tiles (wgmma: N 200, HW 144 and 120);
    # C or HW not a multiple of 8 (mma.sync); one fp32 main-path shape and a
    # ragged one
    for dtype, (b, c, n, h, w), form in (
            (torch.bfloat16, (BS, 1024, 200, 9, 16), "wgmma"),
            (torch.bfloat16, (3, 520, 72, 8, 15), "wgmma"),
            (torch.bfloat16, (3, 520, 72, 9, 15), "mma_sync"),
            (torch.bfloat16, (2, 36, 24, 5, 8), "mma_sync"),
            (torch.float32, (BS, 512, 256, 20, 20), "fma"),
            (torch.float32, (3, 37, 19, 3, 5), "fma")):
        key = "bf16" if dtype == torch.bfloat16 else "fp32"
        args = k5_inputs(g, b, c, n, h, w, dtype)
        if form_for(args[0], args[1]) != form:
            fail(f"K5 ({b}, {c}, {h}, {w}) -> {n} takes {form_for(args[0], args[1])}, not {form}")
        err = k5_compare(args, K5_TOL[key])
        print(f"K5 {key} {form} ({b}, {c}, {h}, {w}) -> {n}: max_abs_err {err:.3g} "
              f"(tol {K5_TOL[key]})", flush=True)

    names = ("ms", "mma_sync_ms", "plain_ms", "cudnn_ms", "cublas_ms", "unfused_ms")
    tot = dict.fromkeys(names + ("bound_ms", "bytes_s", "ops_s"), 0.0)
    err_max = 0.0
    for c, n, h, w in shapes:
        args = k5_inputs(g, BS, c, n, h, w, torch.bfloat16)
        err_max = max(err_max, k5_compare(args, K5_TOL["bf16"]))
        x, wt, scale, bias = args
        if not torch.equal(fused_pointwise_conv_cuda(*args), fused_pointwise_conv_cuda(*args)):
            fail(f"K5 at ({BS}, {c}, {h}, {w}) -> {n}: two calls on one input differ")
        conv = Conv(c, n, 1, 1).cuda().eval()
        conv.conv.to(torch.bfloat16)
        with torch.no_grad():
            conv.conv.weight.copy_(wt[:, :, None, None])
            conv.bn.running_var.copy_(scale)
            conv.bn.running_mean.copy_(bias)
        w4 = wt[:, :, None, None].contiguous()
        xv = x.view(BS, c, h * w)
        with torch.inference_mode():
            # the wgmma and mma.sync forms back to back, then the yardsticks
            tot["ms"] += cuda_ms(lambda: fused_pointwise_conv_cuda(*args), iters=10)
            tot["mma_sync_ms"] += cuda_ms(lambda: launch_form(*args, "mma_sync"), iters=10)
            tot["plain_ms"] += cuda_ms(lambda: fused_pointwise_conv_plain(*args), iters=5)
            tot["cudnn_ms"] += cuda_ms(lambda: F.conv2d(x, w4), iters=10)
            tot["cublas_ms"] += cuda_ms(lambda: torch.matmul(wt, xv), iters=10)
            tot["unfused_ms"] += cuda_ms(lambda: conv(x), iters=10)
        nbytes = (BS * c * h * w + n * c + BS * n * h * w) * 2 + 2 * n * 4
        ops = 2.0 * BS * n * c * h * w
        tb, to = nbytes / HBM_BYTES_S * 1e3, ops / BF16_FLOP_S * 1e3
        tot["bound_ms"] += max(tb, to)
        tot["bytes_s" if tb >= to else "ops_s"] += max(tb, to)
        del args, x, wt, scale, bias, conv, w4, xv
    args = k5_inputs(g, BS, 512, 256, 40, 40, torch.bfloat16)
    host = {f"host_us_per_call_{form}": host_us(lambda: launch_form(*args, form))
            for form in ("wgmma", "mma_sync")}
    print(json.dumps({"fused_conv_shapes": dict(
        calls=len(shapes), batch=BS, shapes_c_n_h_w=[list(s) for s in shapes], form="wgmma",
        max_abs_err=err_max, bit_equal_reruns=True, k5_wgmma_ms=tot["ms"],
        k5_mma_sync_ms=tot["mma_sync_ms"], cudnn_conv2d_bf16_ms=tot["cudnn_ms"],
        cublas_matmul_bf16_ms=tot["cublas_ms"], unfused_conv_bn_silu_ms=tot["unfused_ms"],
        plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"], bytes_bound_part_ms=tot["bytes_s"],
        operations_bound_part_ms=tot["ops_s"], **host)}), flush=True)
    if not tot["ms"] < tot["mma_sync_ms"]:
        fail(f"K5: the wgmma form ({tot['ms']:.3f} ms) is not faster than the mma.sync form "
             f"({tot['mma_sync_ms']:.3f} ms) over the 24 calls")
    return dict(max_abs_err=err_max, ms=tot["ms"], mma_sync_ms=tot["mma_sync_ms"],
                plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                bound_by="operations" if tot["ops_s"] > tot["bytes_s"] else "bytes",
                library_ms=min(tot["cudnn_ms"], tot["cublas_ms"]))


def random_weights_plan(model_cfg=None):
    """The flagship plan, pointed at a checkpoint that does not exist, so the
    Detector takes its seeded random init; ``model_cfg`` swaps the net."""
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    plan = TrainPlan("cfg/coco_train.yaml")
    plan.save_path = os.path.join(HERE, "runs", "chip_smoke_random_init.msgpack")
    if os.path.exists(os.path.splitext(plan.save_path)[0] + ".pth"):
        fail(f"{plan.save_path} has a .pth beside it; the smoke test uses random weights")
    if model_cfg is not None:
        plan.model_cfg = model_cfg
    return plan


def ibin_net() -> dict:
    """cfg/net/yolov7.yaml with its head row swapped to IBin, built in memory
    as scripts/head_ablation.py:37-48 builds its nets."""
    from yolo_continuous_tpu_torch.config.plan import cvt_cfg
    net = copy.deepcopy(cvt_cfg("cfg/net/yolov7.yaml"))
    if net["head"][-1][2] != "Detect":
        fail(f"cfg/net/yolov7.yaml ends in {net['head'][-1][2]}, not Detect")
    net["head"][-1][2] = "IBin"
    return net


def reference_pair(model_cfg=None, fused_tails=False):
    """A CPU fp32 Detector at 64 px with weights at a scale that keeps
    activations O(1) through the depth (so the maps depend on the input and
    the scores are spread), and a CUDA fp32 Detector with the same weights."""
    import torch
    from yolo_continuous_tpu_torch.detect_api import Detector
    plan = random_weights_plan(model_cfg)
    plan.image_size = 64
    cpu = Detector(plan, device="cpu", dtype=torch.float32, seed=1, fused_tails=fused_tails)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in cpu.model.state_dict().items():
            if name.endswith("weight") and t.dim() == 4:
                t.normal_(0.0, (1.0 / t[0].numel()) ** 0.5, generator=gen)
            elif name.endswith(("running_mean", "bias")):
                t.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)
    gpu = Detector(plan, device="cuda", dtype=torch.float32, state_dict=cpu.model.state_dict(),
                   fused_tails=fused_tails)
    return cpu, gpu


def check_maps(what, maps_c, maps_g, n):
    import torch
    if len(maps_c) != n or len(maps_g) != n:
        fail(f"{what}: {len(maps_g)} CUDA and {len(maps_c)} CPU maps, expected {n}")
    for c, g in zip(maps_c, maps_g):
        if g.shape != c.shape or not torch.allclose(g.cpu(), c, atol=5e-3, rtol=2e-3):
            fail(f"{what}: CUDA forward differs from the CPU forward: "
                 f"{(g.cpu() - c).abs().max().item()}")


def check_rows_and_keep(what, pred_c, pred_g):
    import torch
    from yolo_continuous_tpu_torch.ops.nms import suppress, suppress_plain, top_candidates
    if not torch.allclose(pred_g.cpu(), pred_c, atol=1e-4, rtol=1e-4):
        fail(f"{what}: CUDA decode differs from the CPU decode: "
             f"{(pred_g.cpu() - pred_c).abs().max().item()}")
    boxes, _, classes, valid = top_candidates(pred_g, 0.01, min(300, pred_g.shape[1]))
    keep = suppress(boxes, classes, valid, IOU)
    if not torch.equal(keep, suppress_plain(boxes, classes, valid, IOU)):
        fail(f"{what}: NMS keep-set on the CUDA rows differs from the plain version")
    return int(valid.sum()), int(keep.sum())


def phase_reference():
    """CUDA Detectors (fp32) against the same seeded CPU Detectors (plain)."""
    import torch
    from yolo_continuous_tpu_torch.kernels.bin_decode import decode_outputs_bin_cuda
    from yolo_continuous_tpu_torch.kernels.fused_conv import fused_pointwise_conv_cuda
    from yolo_continuous_tpu_torch.ops.decode import decode_outputs, decode_outputs_bin

    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype("float32")
    cpu, gpu = reference_pair()
    maps_c, maps_g = cpu.forward(x), gpu.forward(x)
    check_maps("yolov7", maps_c, maps_g, 3)
    with torch.inference_mode():
        n_valid, n_kept = check_rows_and_keep(
            "yolov7", decode_outputs(maps_c, cpu.spec.anchors, cpu.spec.strides),
            decode_outputs(maps_g, gpu.spec.anchors, gpu.spec.strides))
    print(f"reference: yolov7 @64 fp32 CUDA == CPU (maps atol 5e-3, rows atol 1e-4); "
          f"keep-set exact, {n_valid} valid, {n_kept} kept", flush=True)

    cpu, gpu = reference_pair(ibin_net())
    maps_c, maps_g = cpu.forward(x), gpu.forward(x)
    check_maps("yolov7-IBin", maps_c, maps_g, 3)
    nb = gpu.spec.bin_count
    gap = min(min_bin_gap(maps_c, nb), min_bin_gap(maps_g, nb))
    if not gap > BIN_GAP:
        fail(f"yolov7-IBin reference maps break the argmax-gap precondition: {gap}")
    n4 = decode_outputs_bin_cuda.launches
    with torch.inference_mode():
        n_valid, n_kept = check_rows_and_keep(
            "yolov7-IBin", decode_outputs_bin(maps_c, cpu.spec.anchors, cpu.spec.strides, nb),
            decode_outputs_bin(maps_g, gpu.spec.anchors, gpu.spec.strides, nb))
    if decode_outputs_bin_cuda.launches - n4 != 1:
        fail("yolov7-IBin reference: the CUDA rows did not come from one K4 launch")
    print(f"reference: yolov7-IBin @64 fp32 CUDA == CPU (K4 rows atol 1e-4, min bin gap "
          f"{gap:.3g}); keep-set exact, {n_valid} valid, {n_kept} kept", flush=True)

    cpu, gpu = reference_pair("cfg/net/yolov7-aux.yaml")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        check_maps("yolov7-aux", cpu.model(xt), gpu.model(xt.cuda()), 6)
    print("reference: yolov7-aux @64 fp32 CUDA == CPU, all 6 maps (atol 5e-3)", flush=True)

    cpu, gpu = reference_pair(fused_tails=True)
    n5 = fused_pointwise_conv_cuda.launches
    maps_c, maps_g = cpu.forward(x), gpu.forward(x)
    torch.cuda.synchronize()
    if fused_pointwise_conv_cuda.launches - n5 != 24:
        fail(f"yolov7 fused_tails reference: K5 launched "
             f"{fused_pointwise_conv_cuda.launches - n5} times, not 24")
    check_maps("yolov7 fused_tails", maps_c, maps_g, 3)
    print("reference: yolov7 fused_tails @64 fp32 CUDA (K5 fp32, 24 calls) == CPU "
          "(maps atol 5e-3)", flush=True)


def counters():
    from yolo_continuous_tpu_torch.kernels.bin_decode import decode_outputs_bin_cuda
    from yolo_continuous_tpu_torch.kernels.decode import decode_outputs_cuda
    from yolo_continuous_tpu_torch.kernels.fused_conv import fused_pointwise_conv_cuda
    from yolo_continuous_tpu_torch.kernels.nms import nms_suppress, nms_suppress_tiled
    return (decode_outputs_cuda, nms_suppress, nms_suppress_tiled, decode_outputs_bin_cuda,
            fused_pointwise_conv_cuda)


def drive_path(label, det, images, max_dets):
    """One main path: counters to 0, ``len(max_dets)`` requests, counters
    read; outputs checked. Returns the launches of each kernel."""
    import torch
    det(images, CONF, IOU, 300)          # warm cuDNN before the counted run
    torch.cuda.synchronize()
    for fn in counters():
        fn.launches = 0
    outs = [det(images, CONF, IOU, m) for m in max_dets]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters()}
    for max_det, (boxes, scores, classes, valid) in zip(max_dets, outs):
        if boxes.shape != (BS, max_det, 4) or scores.shape != (BS, max_det):
            fail(f"{label} path output shape {tuple(boxes.shape)}")
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            fail(f"{label} path output is not finite")
        if bool((scores[valid] < CONF).any()) or bool((classes[valid] >= det.spec.nc).any()):
            fail(f"{label} path kept a detection under the threshold or of an unknown class")
    print(f"{label} path: launches {launches}; kept per image "
          f"{float(outs[0][3].sum()) / BS}", flush=True)
    return launches


def stage_times(det, images, decode):
    """Stage times of one request at max_det 300, CUDA events."""
    import torch
    from yolo_continuous_tpu_torch.ops.nms import batched_nms, suppress, top_candidates
    with torch.inference_mode():
        maps = det.forward(images)
        pred = decode(maps)
        boxes, _, classes, valid = top_candidates(pred, CONF, 300)
        stages = dict(
            forward_ms=cuda_ms(lambda: det.forward(images), iters=10, hold=False),
            decode_ms=cuda_ms(lambda: decode(maps), hold=False),
            nms_ms=cuda_ms(lambda: batched_nms(pred, CONF, IOU, 300), hold=False),
            # the NMS stage's two parts, device time
            nms_top_candidates_ms=cuda_ms(lambda: top_candidates(pred, CONF, 300)),
            nms_suppress_ms=cuda_ms(lambda: suppress(boxes, classes, valid, IOU)),
            total_ms=cuda_ms(lambda: det(images, CONF, IOU, 300), iters=10, hold=False))
    stages["img_s"] = BS / stages["total_ms"] * 1e3
    return stages


def phase_main():
    """The main paths at full width, with launch counts and stage times."""
    import torch
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.kernels.bin_decode import form_for as bin_form_for
    from yolo_continuous_tpu_torch.kernels.decode import form_for
    from yolo_continuous_tpu_torch.ops.decode import decode_outputs, decode_outputs_bin

    rs = np.random.RandomState(0)
    images = torch.from_numpy(rs.rand(BS, SIZE, SIZE, 3).astype("float32")).cuda()
    total = {fn.__name__: 0 for fn in counters()}
    paths = (
        ("default", dict(), (300, 300, 300, 4096),
         ("decode_outputs_cuda", "nms_suppress", "nms_suppress_tiled"),
         {"decode_outputs_cuda": 4, "decode_outputs_bin_cuda": 0, "fused_pointwise_conv_cuda": 0}),
        ("ibin", dict(model_cfg=ibin_net()), (300, 300, 300),
         ("decode_outputs_bin_cuda", "nms_suppress"),
         {"decode_outputs_bin_cuda": 3, "decode_outputs_cuda": 0, "fused_pointwise_conv_cuda": 0}),
        ("fused_tails", dict(fused_tails=True), (300, 300, 300),
         ("fused_pointwise_conv_cuda", "decode_outputs_cuda", "nms_suppress"),
         {"fused_pointwise_conv_cuda": 72, "decode_outputs_cuda": 3, "decode_outputs_bin_cuda": 0}),
    )
    dets = {}
    for label, kw, max_dets, must, exact in paths:
        det = dets[label] = Detector(random_weights_plan(kw.get("model_cfg")), device="cuda",
                                     seed=0, fused_tails=kw.get("fused_tails"))
        launches = drive_path(label, det, images, max_dets)
        for name in must:
            if launches[name] == 0:
                fail(f"{label} path never launched {name}")
        for name, n in exact.items():
            if launches[name] != n:
                fail(f"{label} path launched {name} {launches[name]} times, not {n} "
                     f"({len(max_dets)} requests)")
        for name, n in launches.items():
            total[name] += n

        spec = det.spec
        with torch.inference_mode():
            maps = det.forward(images)
        if spec.head_name == "IBin":
            form = bin_form_for(maps, spec.bin_count)

            def decode(maps):
                return decode_outputs_bin(maps, spec.anchors, spec.strides, spec.bin_count)
        else:
            form = form_for(maps)

            def decode(maps):
                return decode_outputs(maps, spec.anchors, spec.strides)
        if form != "tma":
            fail(f"{label} path: the decode takes the {form} form, not tma")
        del maps
        stages = stage_times(det, images, decode)
        if label in ("default", "fused_tails"):
            # host time to enqueue one request on an idle card: near total_ms,
            # the host and not the card sets the pace
            host_ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                det(images, CONF, IOU, 300)
                host_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            stages["host_enqueue_ms"] = float(np.median(host_ms))
        net = "yolov7-IBin" if label == "ibin" else "yolov7"
        print(json.dumps({"main_path": dict(
            path=label, config=f"cfg/coco_train.yaml {net} 640px bf16", head=spec.head_name,
            fused_tails=det.fused_tails, batch=BS, conf=CONF, iou=IOU, max_det=300,
            **stages)}), flush=True)
        print(json.dumps({"profile": dict(path=label, **profile_window(
            lambda: det(images, CONF, IOU, 300)))}), flush=True)

    # the paths against each other in turns (ABC, CBA, ...), so that a drift
    # of the host or the card falls on all of them alike
    turns = {label: dict(forward_ms=[], total_ms=[]) for label in dets}
    with torch.inference_mode():
        for r in range(4):
            for label in (list(dets) if r % 2 == 0 else list(dets)[::-1]):
                det = dets[label]
                turns[label]["forward_ms"].append(
                    cuda_ms(lambda: det.forward(images), iters=10, warmup=2, hold=False))
                turns[label]["total_ms"].append(
                    cuda_ms(lambda: det(images, CONF, IOU, 300), iters=10, warmup=2, hold=False))
    print(json.dumps({"paths_in_turns": {
        label: dict(median_forward_ms=float(np.median(t["forward_ms"])),
                    median_total_ms=float(np.median(t["total_ms"])), **t)
        for label, t in turns.items()}}), flush=True)
    return total


def profile_window(fn, calls: int = 3, grad: bool = False) -> dict:
    """Kernel time by name and the device's busy share over a few calls
    (torch.profiler; the profiler's own cost is in the wall time); ``grad``
    for a train step, inference mode otherwise."""
    import contextlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mode = contextlib.nullcontext() if grad else torch.inference_mode()
    with mode, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # device-side events only: the CPU-side aten ops carry their kernels'
    # time as well, and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / calls) for e in events),
                  key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    if device_ms == 0:
        return {"device_ms": "not measured: the profiler saw no device time"}
    return {"calls": calls, "wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "kernels": len(rows),
            "launches_per_call": sum(e.count for e in events) / calls,
            "top": [[name[:70], ms] for name, ms in rows[:10]]}


def train_inputs(rs, bs: int, size: int, max_boxes: int, device):
    """Images from ``rs`` and the JAX bench's two labels an image
    (bench.py:126-133)."""
    import torch
    images = torch.from_numpy(rs.rand(bs, size, size, 3).astype("float32")).to(device)
    labels = np.zeros((bs, max_boxes, 5), np.float32)
    labels[:, 0] = [1, 0.5, 0.5, 0.4, 0.4]
    labels[:, 1] = [3, 0.3, 0.3, 0.2, 0.25]
    lmask = np.zeros((bs, max_boxes), bool)
    lmask[:, :2] = True
    return images, torch.from_numpy(labels).to(device), torch.from_numpy(lmask).to(device)


def flat_state(state) -> dict:
    """Every tensor of a train state, by name, copied: the model, the EMA,
    the optimizer's buffers."""
    out = {f"model.{k}": v.detach().clone() for k, v in state["model"].state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in state["ema"].tree.items()})
    opt = state["opt"].state_dict()["state"]
    for i, st in opt.items():
        out.update({f"opt.{i}.{k}": v.clone() for k, v in st.items() if hasattr(v, "clone")})
    return out


def phase_train():
    """The train step of yolov7 @640, batch 16, at full width on the card."""
    import torch
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.train.checkpoint import (save_checkpoint,
                                                            train_checkpoint_path, try_load)
    from yolo_continuous_tpu_torch.train.train_loop import Trainer

    plan = TrainPlan("cfg/coco_train.yaml")
    plan.image_size, plan.batch_size, plan.max_boxes = SIZE, BS, 64
    plan.save_path = os.path.join(HERE, "runs", "chip_smoke_train.msgpack")
    trainer = Trainer(plan, device="cuda")
    state = trainer.init_state(seed=0)
    images, labels, lmask = train_inputs(np.random.RandomState(0), BS, SIZE, 64, "cuda")
    hyper = (0.01, 0.1, 0.937)
    before = flat_state(state)
    torch.cuda.reset_peak_memory_stats()

    def step():
        return trainer.train_step(state, images, labels, lmask, *hyper)[1]

    parts = [step()]                           # warm-up (cuDNN picks its algorithms)
    torch.cuda.synchronize()
    step_ms, host_ms = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        parts.append(step())
        host_ms.append((time.perf_counter() - t0) * 1e3)   # enqueued; the card still runs
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    parts = [{k: float(v) for k, v in p.items()} for p in parts]
    for i, p in enumerate(parts):
        if not all(np.isfinite(v) for v in p.values()):
            fail(f"train step {i}: a loss is not finite: {p}")
        if not p["num_fg"] > 0:
            fail(f"train step {i}: num_fg = {p['num_fg']}, SimOTA assigned nothing")
    after = flat_state(state)
    moved = {part: max((after[k].float() - before[k].float()).abs().max().item()
                       for k in before if k.startswith(part + ".") and before[k].is_floating_point())
             for part in ("model", "ema")}
    if not (moved["model"] > 0 and moved["ema"] > 0):
        fail(f"train: the parameters or the EMA did not move: {moved}")

    path = train_checkpoint_path(plan.save_path)
    save_checkpoint(path, state)
    other = Trainer(plan, device="cuda")
    loaded = try_load(path, other.init_state(seed=1))
    back = flat_state(loaded)
    if loaded["step"] != state["step"] or loaded["ema"].updates != state["ema"].updates:
        fail("train checkpoint: step or EMA counter did not load back")
    if set(back) != set(after) or not all(torch.equal(back[k], after[k]) for k in after):
        fail("train checkpoint: the state saved on the card does not load back bit-equal")
    os.remove(path)
    del other, loaded, back, before

    prof = profile_window(step, calls=2, grad=True)
    print(json.dumps({"train_step": dict(
        config="cfg/coco_train.yaml yolov7 640px bf16 body, fp32 master weights", batch=BS,
        max_boxes=64, lr_w=hyper[0], lr_b=hyper[1], mom=hyper[2], steps=10,
        step_ms_median=float(np.median(step_ms)), step_ms_min=min(step_ms),
        step_ms_max=max(step_ms), img_s=BS / float(np.median(step_ms)) * 1e3,
        host_enqueue_ms_median=float(np.median(host_ms)), host_enqueue_ms=host_ms,
        max_memory_allocated_gb=peak / 2 ** 30, first=parts[0], last=parts[-1],
        num_fg=parts[-1]["num_fg"], moved=moved, checkpoint="bit-equal after load",
        launches_per_step=prof.get("launches_per_call"), profile=prof)}), flush=True)
    del trainer, state
    torch.cuda.empty_cache()


def rel_l2(got: dict, want: dict) -> float:
    import torch
    num = sum(float(((got[k].cpu().double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def phase_train_reference():
    """One fp32 train step of yolov7-tiny @128, batch 2, on the card and on
    the CPU from the same weights."""
    import torch
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.train.train_loop import Trainer

    plan = TrainPlan("cfg/coco_train.yaml")
    plan.model_cfg = "cfg/net/yolov7-tiny.yaml"
    plan.image_size, plan.batch_size, plan.max_boxes = 128, 2, 8
    cpu = Trainer(plan, device="cpu", dtype=torch.float32)
    gpu = Trainer(plan, device="cuda", dtype=torch.float32)
    sd = {k: v.clone() for k, v in cpu.init_state(seed=0)["model"].state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():            # O(1) activations through the depth, as reference_pair
        for name, t in sd.items():
            if name.endswith("weight") and t.dim() == 4:
                t.normal_(0.0, (1.0 / t[0].numel()) ** 0.5, generator=gen)
            elif name.endswith(("running_mean", "bias")):
                t.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)
    rs = np.random.RandomState(2)
    images, labels, lmask = train_inputs(rs, 2, 128, 8, "cpu")
    labels[1, 2] = torch.tensor([7, 0.7, 0.6, 0.3, 0.35])
    lmask[1, 2] = True
    out = {}
    for name, tr in (("cpu", cpu), ("cuda", gpu)):
        state = tr.init_state(state_dict=sd)
        old = {k: v.detach().clone() for k, v in state["model"].state_dict().items()}
        _, parts = tr.train_step(state, images.to(tr.device), labels.to(tr.device),
                                 lmask.to(tr.device), 0.01, 0.1, 0.937)
        model = state["model"]
        out[name] = dict(
            parts={k: float(v) for k, v in parts.items()},
            grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            updates={k: (v.detach() - old[k]).cpu() for k, v in model.state_dict().items()
                     if v.is_floating_point()})
    c, g = out["cpu"], out["cuda"]
    for k in ("loss", "box", "obj", "cls"):
        if not abs(g["parts"][k] - c["parts"][k]) <= STEP_LOSS_RTOL * abs(c["parts"][k]):
            fail(f"train reference: {k} {g['parts'][k]} on the card, {c['parts'][k]} on the CPU")
    if g["parts"]["num_fg"] != c["parts"]["num_fg"] or not c["parts"]["num_fg"] > 0:
        fail(f"train reference: num_fg {g['parts']['num_fg']} on the card, "
             f"{c['parts']['num_fg']} on the CPU")
    errs = {"grads": rel_l2(g["grads"], c["grads"]), "updates": rel_l2(g["updates"], c["updates"])}
    if not max(errs.values()) <= STEP_REL_L2:
        fail(f"train reference: card vs CPU relative L2 {errs} > {STEP_REL_L2}")
    print(json.dumps({"train_reference": dict(
        config="yolov7-tiny 128px fp32 batch 2", cpu=c["parts"], cuda=g["parts"],
        rel_l2=errs, loss_rtol=STEP_LOSS_RTOL, rel_l2_tol=STEP_REL_L2)}), flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on the GPU")
    os.chdir(HERE)
    sys.path.insert(0, HERE)
    try:
        from yolo_continuous_tpu_torch.config.plan import cvt_cfg
        from yolo_continuous_tpu_torch.kernels import _build
        from yolo_continuous_tpu_torch.nn.builder import build_model_spec
    except ImportError as e:
        fail(f"the port package is not beside chip_smoke.py: {e}")

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(_build.SIGNATURES)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    plan = random_weights_plan()
    spec = build_model_spec(cvt_cfg(plan.model_cfg), plan.image_chan, plan.anchors,
                            plan.num_labels, plan.anchors_mask)
    bin_spec = build_model_spec(ibin_net(), plan.image_chan, plan.anchors, plan.num_labels,
                                plan.anchors_mask)
    k5_shapes = fused_tail_shapes()
    if len(k5_shapes) != 24:
        fail(f"yolov7 @640 fused tails: {len(k5_shapes)} K5 calls, expected 24")
    report = phase_kernels(spec, bin_spec, k5_shapes)
    phase_reference()
    launches = phase_main()
    phase_train()
    phase_train_reference()

    meta = {
        "decode_level": ("csrc/decode.cu", "yolo_continuous_tpu/kernels/decode_pallas.py:67",
                         "decode_outputs_cuda"),
        "nms_suppress": ("csrc/nms.cu", "yolo_continuous_tpu/kernels/nms_pallas.py:64",
                         "nms_suppress"),
        "nms_suppress_tiled": ("csrc/nms.cu", "yolo_continuous_tpu/kernels/nms_pallas.py:131",
                               "nms_suppress_tiled"),
        "decode_level_bin": ("csrc/bin_decode.cu",
                             "yolo_continuous_tpu/kernels/bin_decode_pallas.py:80",
                             "decode_outputs_bin_cuda"),
        "fused_conv": ("csrc/fused_conv.cu",
                       "yolo_continuous_tpu/kernels/fused_conv_pallas.py:37",
                       "fused_pointwise_conv_cuda"),
    }
    kernels = []
    for name, (src, replaces, counter) in meta.items():
        r = report[name]
        # the form timed beside the main one: K3's and K4's strided form, K5's mma.sync form;
        # K1's times at 300 x 1 and 1024 x 16, its launch floor and host time
        other = {k: r[k] for k in ("strided_ms", "mma_sync_ms", "ms_300x1", "ms_1024x16",
                                   "launch_floor_ms", "host_us", "ms_25200x2",
                                   "bound_ms_25200x2") if k in r}
        kernels.append(dict(name=name, route="cuda", source=f"yolo_continuous_tpu_torch/{src}",
                            replaces=replaces, launches=launches[counter],
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"], **other))
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
