#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the root of a checkout, one card

It imports only ``torch``, numpy and the port package
``yolo_continuous_tpu_torch`` (nothing of JAX), and runs in phases; any
failure exits non-zero before the result line.

1. build: compiles the port's CUDA kernels (``csrc/*.cu``, one ``nvcc``
   each, in parallel: K1-K5 and the stager) and prints the seconds and the
   ptxas report.
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
   in turns. Requests are the captured request (``Detector.__call__``
   replays one CUDA graph per key and shape, ``utils/capture.py``); each
   path's routes (bs 16, bs 1 but IBin, and max_det 4096 with K2 in the
   graph) are held bit-equal to the eager request (``infer_eager``) in the
   same process, eager first to itself (``replay_equal``). Last, for the
   default and fused-tail paths at bs 16 and 1, captured against eager
   (``captured_vs_eager``): request ms in 10 alternating turns (median,
   min, max), host ms a call, device ms, kernels and host launches a
   request (profiler), first-call ms, warm-up and capture ms, pool memory.
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
   It also times the step with ``cudnn.deterministic`` (the Trainer's
   setting on CUDA, for exact resume) and without it, in 10 alternating
   turns: device time (the profiler's sum of the step's kernels), which
   decides its cost, and host wall time. Then the compiled step
   (``Trainer.jitted_train_step()``: one captured CUDA graph, whose first
   call is the warm-up and a real step) against the eager one
   (``captured_vs_eager_train``): two Trainers from seed 0 over 5 steps of
   the plan's warm-up ramp (lr_w, lr_b and mom change every step), every
   loss part and every state tensor bit-equal; the first call's ms, warm-up
   and capture ms, graph pool, reserved and peak memory; both in 10
   alternating turns (median, min, max; host ms a step) and under the
   profiler (kernel ms, kernels and host launches a step); the same for
   ``jitted_eval_loss()`` against ``eval_loss``. Then one step of yolov7-tiny @128, batch 2, fp32, on the card and on the
   CPU from the same weights: loss parts, ``num_fg``, gradients and updated
   parameters must agree within the CPU parity tests' tolerances
   (``tests/test_torch_port_train.py``).
6. train_run: ``Trainer.run`` trains yolov7 @640 from a plan: a copy of
   ``cfg/coco_train.yaml`` pointed at a JPEG dataset the phase writes
   (64 train and 16 val images of mixed aspect ratios, 1-8 boxes each, from
   ``RandomState(0)``), batch 16, bf16 body, ``mosaic_prob`` and
   ``mixup_prob`` 0.5 (the stock enhance YAML never mosaics), UD flips from
   the enhance YAML, ``val_map_every: 1``, 3 epochs: the first 2 with
   ``device_cache`` on (``stop_after_epoch: 2``), then resumed from
   ``.last`` for the third with it off (the prefetch thread staging through
   the card's stager, as the pool was staged); every step through the
   compiled step. The resumed run's state must equal an uninterrupted
   3-epoch run's bit for bit. It prints each epoch's
   line and a JSON record (step ms, augment and train-step ms a step by
   CUDA events, the host's data-wait ms of every step, img/s, peak memory,
   mAP), and fails unless every loss is finite, the checkpoints
   (``.train.pt``, ``.last``, ``.bestmap``) exist, every mAP is in [0, 1],
   the resume starts at step 8, and every ``validate_map`` (EMA weights
   through the ``Detector``, max_det 300) launched K3 and K1: their
   counters are set to 0 just before each call and read just after. Then
   one batch's augmentation from the pool, timed alone: the profiler's
   summed kernel time, CUDA events with the stream held, and the host's
   enqueue time.
7. model_zoo: the rest of the model side, seeded random weights, on the card.
   (p6_lite) ``cfg/net/yolov7-p6-lite.yaml`` in a copy of the flagship plan
   with the upstream P6 anchors and mask, 1280 px: requests at batch 16 (bf16
   body, conf 0.25, IoU 0.45, max_det 300), counters set to 0 around each,
   every one launching K3 once in its TMA form over the 4 levels and K1;
   K3 at that shape against its strided form (bit-equal), the plain version
   and its byte bound; stage times and peak memory. Train steps at batch 8,
   max_boxes 64 (the IAuxDetect aux loss at 4 levels): 1 + 5. (ibin_train)
   yolov7 with an IBin head at 640, batch 16, 1 + 5 ``Trainer.train_step``
   through ``bin_yolo_loss``; then a Detector on its EMA weights serves one
   request, which must launch K4 once in its TMA form. (fuse) yolov7 @640
   batch 16: ``Detector(fuse=True)`` against the unfused Detector on the same
   weights in fp32 (maps, rows and detections within 2e-3), both timed in
   bf16 in turns; ``fuse=True, fused_tails=True`` launches K5 24 times a
   request. (head_bf16) ``head_dtype=torch.bfloat16``: K3 once a request
   (its maps cast to fp32 keep the TMA form), the request time, and the
   keep-set entries that differ from the fp32 head. (reload)
   ``reload_weights`` on a running Detector, with and without ``fuse``: the
   reload drops the captured request, and the next replay equals a fresh
   Detector's replay and its eager request on the same checkpoint bit for
   bit; a missing path returns False. The p6_lite, ibin_train, fuse, fuse
   + fused_tails and head_bf16 (bs 16 and 1) requests are each held
   bit-equal to their eager request (``replay_equal``). (zoo) every
   chained group of the zoo's rows
   (the groups of ``tests/_torch_port.py``), the multi-input and repeat nets
   and YoloBody 'l' and 'x' at 64 px on the card against the CPU in fp32
   (maps within 1e-4); one timed forward of YoloBody 'x' at 640, batch 16,
   bf16.
8. serve: int8 PTQ and the serving layer. The int8 Conv's card routes
   (``nn/quant.py``) against the plain version (fp64 on the CPU) from the
   same input, amax and fp32 weights at four yolov7 @640 shapes (the stem,
   a 3x3 stride 2, a 1x1 with C_in 1024, a grouped 3x3), int32 sums and
   outputs bit-equal; a 64 px yolov7 ``Detector(quantize=True)`` in fp32 on
   the card against the CPU (maps within 1e-2 relative L2, K1's keep-set
   equal to the plain one on the card's rows). Then yolov7 @640 on
   ``cfg/coco_train.yaml`` with spread weights from a seed, served by one
   ``make_multi_server`` (batch 16, max_wait 5 ms, conf 0.25, IoU 0.45,
   max_det 100) as two models: ``bf16`` and ``int8``
   (``Detector(quantize=True)`` calibrated on 16 synthetic 640 px images).
   The int8 request replayed bit-equal to eager after ``calibrate``, after
   ``load_quant_state`` of other scales (which it then serves) and after
   loading the calibrated ones back. Direct calls first: int8 against bf16
   request ms in 10 alternating turns, device ms a batch, peak memory,
   launches (profiler), quantized
   Convs and the share of bf16's kept detections that int8 keeps. Then a
   child process (its own interpreter) runs 64 client threads: 256 JPEGs
   of 640 x 480 and 480 x 640 a model (every 32nd urgent), one 32-frame
   ``/detect/bf16/stream`` (answers in frame order), one chunked body; at
   half way a second seeded state dict is saved as ``bf16.pth`` and ``POST
   /models/bf16/reload`` swaps it in. Every answer must be JSON without
   ``error``; ``/stats`` must count what was sent; 8 images' answers must
   equal direct calls bit for bit, before the traffic and after it (bf16
   against a fresh Detector on the new weights); K3 (TMA form) and K1 must
   launch exactly once a served batch (counters at 0 around the window);
   the watcher (``reload_every``) must load a ``.train.pt`` written by
   ``train/checkpoint.save_checkpoint``. Prints ``serve_int8_on_card``,
   ``serve_direct`` and ``serve`` JSON lines (requests/s, batch fill,
   latency percentiles from ``/stats``, host and call ms a batch, launches).
   ``python3 chip_smoke.py --only serve`` builds and runs this phase alone
   (no result line).
9. parallel_and_tools, on ``cfg/coco_train.yaml`` (yolov7 @640, batch 16,
   bf16 body, seeded weights). (perspective) ``Trainer.run`` for one epoch
   on phase 6's plan keys and a copy of its JPEG dataset with
   ``use_perspective: True`` (degrees 10, translate 0.1, scale 0.1, shear 10,
   from the enhance YAML) and ``val_map_every: 1``: fails unless the loss is
   finite, every valid box of every augmented batch lies inside the canvas,
   and the ``validate_map`` call launched K3 in its TMA form (once, beside
   one K1), counters at 0 around it; it prints the epoch's step and augment
   ms (CUDA events) beside phase 6's, and one pool batch's augmentation timed
   alone with and without the perspective. ``EnhancePackage`` with the
   perspective on 16 images of 640 x 480 on the card and on the CPU from the
   same draws: images within 1e-2 on 0..255, boxes and masks bit-equal.
   (remat) 1 + 5 compiled steps (captured) under no remat, ``bn_remat`` and
   ``remat`` full, conv and dots: step ms, peak memory, launches a step;
   the first step's loss parts and running statistics must equal the plain
   step's within rtol 1e-6 (and say whether bit-equal). (mesh)
   ``parallel/distributed.initialize`` as a world of one through NCCL on a
   free port, ``make_mesh(1, 1)``, ``shard_params``, ``shard_batch`` and a
   ``train_step`` bit-equal to the unmeshed step (loss parts and every state
   tensor), its step ms between two plain runs; the group is destroyed.
   Multi-rank meshes are the CPU tests' (``tests/test_torch_port_distributed.py``).
   (tools) ``gen_anchors`` on the phase's boxes (written as VOC XMLs), and
   ``torch_export`` of the phase's ``.train.pt`` to the ``.pth`` that a
   ``Detector`` then reads: its detections on 16 images equal those of a
   ``Detector`` on the ``.train.pt`` bit for bit. Prints a
   ``parallel_and_tools`` JSON line; ``--only parallel_and_tools`` runs
   this phase alone (no result line).
10. native_staging: the JPEG stager (``kernels/staging.py``: cv2 decode in
   a pool of threads, then ``csrc/staging.cu::stage_letterbox``, one launch
   a batch). ``stage_letterbox`` against its plain version on the same
   decoded pixels at S = 640, on the CPU and on the card, bit-equal, for
   640 x 480, 480 x 640, 1280 x 720, 1920 x 1080, 333 x 517, 133 x 65 (the
   fp32 width case), 1 x 1 and a grayscale JPEG; ``stage_batch_native`` on
   the card against the CPU's, tiles, metas and ``ok`` bit-equal. The
   stager alone on a mosaic batch of 64 photo-like JPEGs of 640 x 480:
   read, decode, kernel (device time beside its byte bound) and host ms,
   images/s, against cv2's ``stage_image`` on the same files in 5
   alternating pairs; the kernel bit-equal to its plain version on that
   batch, and on the pixels and geometry table that ``YoloDataset`` hands
   it for one training batch of those files (16 samples x 4 tile slots,
   mosaic 0.5, so with the fill rows of unused slots). Then ``Trainer.run`` of yolov7 @640 bs16 for one
   epoch without the pool (phase 6's plan keys, ``device_cache: false``) on
   256 + 32 JPEGs the phase writes (640 x 480 and 480 x 640 with a few 1280
   x 720, luma grain) plus a grayscale JPEG and a PNG named ``.jpg``, which
   must take the cv2 fallback: counters at 0 around the run, which must
   launch ``stage_letterbox``, K3 and K1; each step's data wait, step and
   epoch time. Then the train loader's staging of one epoch through the
   stager and through cv2 (``use_native=False``), in 3 alternating pairs,
   and ``staged_pool`` of the train set each way, in 2. Prints a
   ``native_staging`` JSON line; ``--only native_staging`` runs this phase
   alone (no result line).
11. bench: the port's bench, ``python -m yolo_continuous_tpu_torch.bench
   16`` in a child process (one more a section), with
   ``BENCH_INFER_EXTRAS=fused_tails,int8``, ``BENCH_TRAIN_MODES=base,bn_remat``
   and a ``BENCH_TOTAL_BUDGET`` of 600 s: yolov7 @640 train steps at batch
   16 with and without ``bn_remat``, bf16-head requests at batch 16 and 1,
   ``nms_single`` of 25,200 candidates, the fused-tail request at batch 1
   and the int8 batch. It fails if the bench's last line holds an
   ``error``, names another device than the card, or lacks one of
   ``value``, ``train_sweep`` "16" and "16/bn_remat", ``infer_img_s``,
   ``infer_1_ms``, ``nms_p50_ms``, ``infer_1_ms_fused_tails`` and
   ``infer_img_s_int8`` > 0. In this process, one call of each function
   the bench times, counters at 0 around each: K3 and K1 once a request,
   K1 once in ``nms_single``, K5 24 times in the fused-tail request
   (``launches_bench`` in the kernels line); on the same inputs K3 on the
   bf16 head's maps at batch 16 and 1, K1 on ``nms_single``'s candidates
   and K5 on the 24 inputs of the batch-1 fused-tail request against their
   plain versions, K5 timed there beside its bound. Prints a ``bench`` JSON
   line (the bench's line, each pass's ms and each section's peak memory,
   the bench's ``infer_img_s`` beside phase 4's default img/s and its
   ``value`` beside phase 5's step img/s, not gated); the bench's stderr is
   kept in ``runs/chip_smoke_bench/``. ``--only bench`` runs this phase
   alone (no result line).

Kernel times are device times: ``cuda_ms`` holds the stream with a sleep
kernel while the host enqueues the timed calls, so that a kernel shorter
than its wrapper's host time is not timed at the host's pace.

Launch counts under replay: a wrapper's ``.launches`` counter moves where it
launches its kernel outside a graph; inside a captured request the launch
goes into the capture's record (``utils/capture.CapturedCall.launches``),
and each replay adds that record to the counters. Every count below (the
exact K3, K4, K5 checks of phases 3-11 and the ``launches_*`` keys of the
kernels line) is thus the captured launches times the replays plus the
launches outside a graph; a capture's warm-up counts nowhere.

Before the last line it prints the ``kernels`` JSON line (time, bound,
error of each kernel; ``launches`` on phase 4's main paths,
``launches_validate_map`` on phase 6's ``validate_map`` calls,
``launches_model_zoo`` on phase 7's counted requests and ``launches_serve``
on phase 8's serving window, ``launches_parallel`` on phase 9's counted
calls, ``launches_native_staging`` on phase 10's run, ``launches_bench`` on
phase 11's calls; K3's 4-level time and bound at the P6 shape; K5's time,
bound and error at batch 1 (``*_bs1``); a sixth entry, ``stage_letterbox``, whose
``launches`` are phase 10's run's, its main path) and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.
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
ANCHOR_ROWS = [[12, 16, 19, 36, 40, 28], [36, 75, 76, 55, 72, 146], [142, 110, 192, 243, 459, 401]]
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


def fused_tail_shapes(batch: int = BS):
    """(C_in, C_out, H, W) of every K5 call of one yolov7 @640 fused-tail
    request at ``batch``, in call order, read off a forward on the card;
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
            det.forward(torch.zeros(batch, SIZE, SIZE, 3, device="cuda"))
    finally:
        layers.fused_pointwise_conv = fn
    torch.cuda.synchronize()
    if set(forms) != {"wgmma"}:
        fail(f"yolov7 @640 fused tails at batch {batch}: K5 forms {forms}, every call must "
             f"take wgmma")
    if len(shapes) != 24:
        fail(f"yolov7 @640 fused tails at batch {batch}: {len(shapes)} K5 calls, expected 24")
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
    spread_weights(cpu.model.state_dict(), 1)
    gpu = Detector(plan, device="cuda", dtype=torch.float32, state_dict=cpu.model.state_dict(),
                   fused_tails=fused_tails)
    return cpu, gpu


def spread_weights(state_dict, seed: int) -> dict:
    """Redraw a state dict in place from ``seed`` at a scale that keeps
    activations O(1) through the depth: conv weights of fan-in n ~ N(0, 1/n),
    biases and running means ~ 0.1 N(0, 1), running variances U(0.5, 1.5)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in state_dict.items():
            if name.endswith("weight") and t.dim() == 4:
                t.normal_(0.0, (1.0 / t[0].numel()) ** 0.5, generator=gen)
            elif name.endswith(("running_mean", "bias")):
                t.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)
    return state_dict


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
    from yolo_continuous_tpu_torch.kernels.staging import stage_letterbox
    return (decode_outputs_cuda, nms_suppress, nms_suppress_tiled, decode_outputs_bin_cuda,
            fused_pointwise_conv_cuda, stage_letterbox)


def drive_path(label, det, images, max_dets):
    """One main path: counters to 0, ``len(max_dets)`` requests, counters
    read; outputs checked. Returns the launches of each kernel."""
    import torch
    det(images, CONF, IOU, 300)          # captures the request (and warms cuDNN) uncounted
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


def differing(got, want) -> list:
    """The names of the request outputs that are not bit-equal."""
    import torch
    return [name for name, g, w in zip(("boxes", "scores", "classes", "valid"), got, want)
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w)]


def replay_equal(label, det, x, conf=CONF, max_det=300) -> dict:
    """The captured request (``Detector.__call__``) against the eager one
    (``Detector.infer_eager``) on the same CUDA input, in this process: eager
    must be bit-equal to eager, then a first call (warm-up, capture and a
    replay) and a second replay bit-equal to eager, all four outputs. Fails
    on any difference. Returns the first call's host ms and the capture's
    record: warm-up and capture ms, pool memory, launches a replay."""
    import torch
    with torch.inference_mode():
        want = det.infer_eager(x, conf, IOU, max_det)
        diff = differing(det.infer_eager(x, conf, IOU, max_det), want)
        if diff:
            fail(f"{label}: the eager request is not bit-equal to itself in {diff}")
        det._drop_graphs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = det(x, conf, IOU, max_det)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        second = det(x, conf, IOU, max_det)
        torch.cuda.synchronize()
    for which, got in (("first call", first), ("replay", second)):
        diff = differing(got, want)
        if diff:
            fail(f"{label}: the captured request's {which} differs from the eager request "
                 f"in {diff}")
    call = det._infer[(tuple(x.shape), x.dtype)]
    return dict(bit_equal_to_eager=True, first_call_ms=first_ms, warmup_ms=call.warmup_ms,
                capture_ms=call.capture_ms, pool_gb=call.pool_bytes / 2 ** 30,
                launches_per_replay=call.launches, kept=int(want[3].sum()))


REPLAY_TURNS = 10


def captured_vs_eager(label, det, x) -> dict:
    """One route at one batch, captured against eager: the bit-equal check
    and first-call cost (``replay_equal``); request ms in REPLAY_TURNS
    alternating turns (CUDA events around 5 calls at the host's pace: median,
    min, max); host ms a call (the clock around the call, without waiting for
    the card; median of the turns); device ms (the stream held while the host
    enqueues); and from a profiler window of 3 calls, the device's kernel
    time and kernels a request, and the launches the host makes a request:
    graph launches plus kernels, copies and fills enqueued outside a graph."""
    import torch
    rec = replay_equal(label, det, x)
    fns = {"captured": lambda: det(x, CONF, IOU, 300),
           "eager": lambda: det.infer_eager(x, CONF, IOU, 300)}
    ms = {k: [] for k in fns}
    host = {k: [] for k in fns}
    with torch.inference_mode():
        for t in range(REPLAY_TURNS):
            for k in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
                ms[k].append(cuda_ms(fns[k], iters=5, warmup=1, hold=False))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[k]()
                host[k].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
        device = {k: cuda_ms(fn, iters=10, warmup=2) for k, fn in fns.items()}
    for k, fn in fns.items():
        prof = profile_window(fn, calls=3)
        rec[k] = dict(request_ms=dict(median=float(np.median(ms[k])), min=min(ms[k]),
                                      max=max(ms[k]), turns=ms[k]),
                      host_ms=float(np.median(host[k])), device_ms=device[k],
                      profile_kernel_ms=prof.get("device_ms"),
                      kernels_per_request=prof.get("launches_per_call"),
                      host_launches_per_request=prof.get("host_launches_per_call"),
                      host_launches_by_call=prof.get("host_launches_by_call"))
    return rec


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
    dets, img_s = {}, {}
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
        # every route of the path: the captured request bit-equal to the eager one
        routes = {f"bs {BS}": replay_equal(f"{label} bs {BS}", det, images)}
        if label != "ibin":
            routes["bs 1"] = replay_equal(f"{label} bs 1", det, images[:1])
        if label == "default":       # K2 inside the graph
            routes[f"bs {BS} max_det 4096"] = replay_equal(f"{label} max_det 4096", det, images,
                                                           max_det=4096)
            if "nms_suppress_tiled" not in routes[f"bs {BS} max_det 4096"]["launches_per_replay"]:
                fail("default path: the max_det 4096 graph holds no K2 launch")
        print(json.dumps({"replay_routes": dict(path=label, **routes)}), flush=True)

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
        img_s[label] = stages["img_s"]
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

    # the captured request against the eager one, where the bench times them
    for label in ("default", "fused_tails"):
        for bs in (BS, 1):
            rec = captured_vs_eager(f"{label} bs {bs}", dets[label], images[:bs])
            print(json.dumps({"captured_vs_eager": dict(path=label, batch=bs, **rec)}),
                  flush=True)
    return total, img_s["default"]


HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


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
    # the host's side: the runtime calls that put work on a stream, a graph
    # launch counting once for all its kernels
    host = {e.key: e.count / calls for e in prof.key_averages()
            if e.key.startswith(HOST_LAUNCH_CALLS)}
    return {"calls": calls, "wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "kernels": len(rows),
            "launches_per_call": sum(e.count for e in events) / calls,
            "host_launches_per_call": sum(host.values()), "host_launches_by_call": host,
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


def deterministic_cost(step, turns: int = 10) -> dict:
    """The train step with cuDNN's deterministic algorithms (the Trainer's
    setting on CUDA, for exact resume, global to the process) and with its
    default ones, in ``turns`` alternating turns after a warm step of each:
    each turn one step timed on the host's clock, then one under
    torch.profiler for its device time (the sum of its kernels' times). The
    cost is read from the device time, since the host paces the step and its
    wall time hides what the algorithms cost on the card. The setting is
    left on."""
    import torch
    wall = {True: [], False: []}
    device = {True: [], False: []}
    for flag in (False, True):
        torch.backends.cudnn.deterministic = flag
        step()
    torch.cuda.synchronize()
    for turn in range(turns):
        for flag in ((False, True) if turn % 2 == 0 else (True, False)):
            torch.backends.cudnn.deterministic = flag
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall[flag].append((time.perf_counter() - t0) * 1e3)
            prof = profile_window(step, calls=1, grad=True)
            device[flag].append(prof["device_ms"])
    torch.backends.cudnn.deterministic = True
    if not all(isinstance(v, float) for v in device[True] + device[False]):
        fail(f"cudnn.deterministic: the profiler saw no device time: {device}")
    on, off = float(np.median(device[True])), float(np.median(device[False]))
    won, woff = float(np.median(wall[True])), float(np.median(wall[False]))
    return dict(on_device_ms_median=on, off_device_ms_median=off, device_cost=on / off - 1.0,
                on_wall_ms_median=won, off_wall_ms_median=woff, wall_cost=won / woff - 1.0,
                on_device_ms=device[True], off_device_ms=device[False], on_wall_ms=wall[True],
                off_wall_ms=wall[False], turns=turns)


def warmup_ramp(plan, n: int) -> list:
    """Steps 1..n of the plan's warm-up ramp (``LRSchedule`` at COCO's
    118,287 images an epoch at batch 16): lr_w, lr_b and mom all change
    every step."""
    from yolo_continuous_tpu_torch.ops.schedules import LRSchedule
    sched = LRSchedule(plan.learn_initial, plan.learn_final, plan.epochs, plan.decay,
                       plan.momentum, plan.warmup, plan.warmup_epochs, plan.warmup_max_iter,
                       plan.warmup_momentum, plan.warmup_bias_lr, 118287 // BS)
    return [(h.lr_weights, h.lr_bias, h.momentum) for h in map(sched, range(1, n + 1))]


def turns_and_profile(fns: dict, turns: int = REPLAY_TURNS) -> dict:
    """Each function in ``turns`` alternating turns (one call a turn: the
    host's clock around the call, which returns once the work is enqueued,
    and until the card is done), then a profiler window of 2 calls: the
    device's kernel ms, kernels a call and the host's launches a call."""
    import torch
    host = {k: [] for k in fns}
    wall = {k: [] for k in fns}
    for t in range(turns):
        for k in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            host[k].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            wall[k].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for k, fn in fns.items():
        prof = profile_window(fn, calls=2, grad=True)
        if not isinstance(prof.get("device_ms"), float):
            fail(f"captured vs eager ({k}): {prof}")
        out[k] = dict(ms=dict(median=float(np.median(wall[k])), min=min(wall[k]),
                              max=max(wall[k]), turns=wall[k]),
                      host_ms=dict(median=float(np.median(host[k])), min=min(host[k]),
                                   max=max(host[k])),
                      kernel_ms=prof["device_ms"], kernels_per_call=prof["launches_per_call"],
                      host_launches_per_call=prof["host_launches_per_call"],
                      host_launches_by_call=prof["host_launches_by_call"],
                      busy_share=prof["busy_share"])
    return out


def first_call(fn, trainer, kind: str) -> dict:
    """The first call of a compiled function (host ms until the card is
    done), with its graph's warm-up and capture ms, pool, and the reserved
    and peak memory after it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    (call,) = [g for key, g in trainer._graphs.items() if key[0] == kind]
    return out, dict(ms=ms, warmup_ms=call.warmup_ms, capture_ms=call.capture_ms,
                     pool_gib=call.pool_bytes / 2 ** 30,
                     reserved_gib=torch.cuda.memory_reserved() / 2 ** 30,
                     peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def step_captured_vs_eager(plan, inputs) -> dict:
    """The compiled train step (``Trainer.jitted_train_step()``, one CUDA
    graph) against the eager one (``train_step``), yolov7 @640, batch 16:
    two Trainers from seed 0 over 5 steps of the warm-up ramp, every loss
    part each step and every tensor of the state after held bit-equal; the
    first call's cost; both steps in alternating turns and under the
    profiler on the first Trainer. The same for ``jitted_eval_loss()``
    against ``eval_loss`` (3 replays bit-equal)."""
    import torch
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    twins = [Trainer(plan, device="cuda") for _ in range(2)]
    states = [tr.init_state(seed=0) for tr in twins]
    compiled, ramp = twins[0].jitted_train_step(), warmup_ramp(plan, 5)
    rec = {"ramp": ramp}
    for i, hyper in enumerate(ramp):
        def step():
            return compiled(states[0], *inputs, *hyper)[1]
        if i == 0:
            got, rec["first_call"] = first_call(step, twins[0], "train_step")
        else:
            got = step()
        want = twins[1].train_step(states[1], *inputs, *hyper)[1]
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        if bad:
            fail(f"captured train step {i}: {bad} differ from the eager step: "
                 f"{ {k: (float(got[k]), float(want[k])) for k in bad} }")
    a, b = flat_state(states[0]), flat_state(states[1])
    bad = [k for k in b if not torch.equal(a[k], b[k])]
    if bad or set(a) != set(b):
        fail(f"captured train step: {len(bad)} of {len(b)} state tensors differ from the eager "
             f"step's after 5 steps, e.g. {bad[:5]}")
    rec.update(bit_equal_steps=len(ramp), state_tensors=len(b))
    del twins[1], states[1], a, b
    torch.cuda.empty_cache()
    trainer, state = twins[0], states[0]
    hyper = ramp[-1]
    rec["train_step"] = turns_and_profile({
        "captured": lambda: compiled(state, *inputs, *hyper),
        "eager": lambda: trainer.train_step(state, *inputs, *hyper)})
    evaluate = trainer.jitted_eval_loss()
    got, first = first_call(lambda: evaluate(state, *inputs), trainer, "eval_loss")
    for _ in range(3):
        want = trainer.eval_loss(state, *inputs)
        if not torch.equal(got, want):
            fail(f"captured eval loss {float(got)} differs from eager {float(want)}")
        got = evaluate(state, *inputs)
    rec["eval_loss"] = dict(first_call=first, bit_equal_replays=3, **turns_and_profile({
        "captured": lambda: evaluate(state, *inputs),
        "eager": lambda: trainer.eval_loss(state, *inputs)}))
    for key in ("train_step", "eval_loss"):
        c = rec[key]["captured"]["host_launches_per_call"]
        if not c < 50:
            fail(f"captured {key}: {c} host launches a call, not a graph launch and a few copies")
    return rec


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
    det_ms = deterministic_cost(step)
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
    del trainer, state
    torch.cuda.empty_cache()
    captured = step_captured_vs_eager(plan, (images, labels, lmask))
    print(json.dumps({"train_step": dict(
        config="cfg/coco_train.yaml yolov7 640px bf16 body, fp32 master weights", batch=BS,
        max_boxes=64, lr_w=hyper[0], lr_b=hyper[1], mom=hyper[2], steps=10,
        step_ms_median=float(np.median(step_ms)), step_ms_min=min(step_ms),
        step_ms_max=max(step_ms), img_s=BS / float(np.median(step_ms)) * 1e3,
        host_enqueue_ms_median=float(np.median(host_ms)), host_enqueue_ms=host_ms,
        max_memory_allocated_gb=peak / 2 ** 30, cudnn_deterministic=det_ms,
        first=parts[0], last=parts[-1],
        num_fg=parts[-1]["num_fg"], moved=moved, checkpoint="bit-equal after load",
        launches_per_step=prof.get("launches_per_call"), profile=prof)}), flush=True)
    print(json.dumps({"captured_vs_eager_train": captured}), flush=True)
    torch.cuda.empty_cache()
    return BS / float(np.median(step_ms)) * 1e3


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
    spread_weights(sd, 1)            # O(1) activations through the depth, as reference_pair
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


def photo_like(rs, w: int, h: int, grain: int = 0):
    """A smooth background with flat boxes of 80 classes' colours, and
    ``grain`` levels of noise of luma; returns (image, box strings)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = rs.randint(40, 200, 3)
    img = np.clip(base + 40 * np.sin(xx / rs.uniform(20, 80))[..., None]
                  + 30 * np.cos(yy / rs.uniform(20, 80))[..., None], 0, 255).astype(np.uint8)
    boxes = []
    for _ in range(rs.randint(1, 9)):
        bw, bh = rs.randint(w // 12, w // 3), rs.randint(h // 12, h // 3)
        x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
        cls = rs.randint(80)
        img[y:y + bh, x:x + bw] = ((cls * 37) % 256, (cls * 91) % 256, (cls * 53) % 256)
        boxes.append(f"{x},{y},{x + bw},{y + bh},{cls}")
    if grain:
        img = np.clip(img + rs.randint(-grain, grain + 1, (h, w, 1)), 0, 255).astype(np.uint8)
    return img, boxes


def write_jpeg_dataset(root: str, n: int, rs, prefix: str,
                       shapes=((480, 640), (640, 480), (512, 512), (360, 640), (640, 427)),
                       grain: int = 0) -> str:
    """``n`` JPEGs of ``shapes`` (h, w; cycled) under ``root``, each
    ``photo_like``, and their annotation file; returns its path."""
    import cv2
    lines = []
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        img, boxes = photo_like(rs, w, h, grain)
        path = os.path.join(root, f"{prefix}{i:03d}.jpg")
        cv2.imwrite(path, img)
        lines.append(" ".join([path] + boxes) + "\n")
    ann = os.path.join(root, f"{prefix}.txt")
    with open(ann, "w") as f:
        f.writelines(lines)
    return ann


def plan_copy(root: str, name: str, **keys) -> str:
    """``cfg/coco_train.yaml`` copied to ``root/name`` with ``keys`` set (its
    own lines replaced, the others appended)."""
    with open("cfg/coco_train.yaml") as f:
        lines = f.read().splitlines()
    out = [line for line in lines if line.split(":")[0].strip() not in keys]
    out += [f"{k}: {v}" for k, v in keys.items()]
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
    return path


def augment_alone(trainer, train_ann: str, cfgs=None) -> dict:
    """One batch's augmentation from the device pool, as epoch 1 of the
    run draws it (the draws and indices already on the card), timed alone:
    the profiler's summed kernel time and launches, CUDA events with the
    stream held while the host enqueues, and the host's enqueue time. With
    ``cfgs`` (name -> AugConfig), a record a config from one staged pool."""
    from yolo_continuous_tpu_torch.data.dataset import YoloDataset, load_annotation_file
    from yolo_continuous_tpu_torch.ops.augment import augment_batch_from_pool, to_device
    plan = trainer.plan
    ds = YoloDataset(load_annotation_file(train_ann), plan.image_size, plan.max_boxes,
                     plan.mosaic, plan.mixup, plan.mosaic_prob, plan.mixup_prob, 2,
                     plan.special_aug_ratio, seed=plan.seed)
    pool = [to_device(a, "cuda") for a in ds.staged_pool()]
    ds.reseed(0)
    tile_idx, mosaic, mixup = next(ds.epoch_plans(BS, plan.shuffle, plan.drop_last))
    idx = to_device(tile_idx, "cuda")
    own, out = trainer.aug_cfg, {}
    for name, cfg in (cfgs or {None: own}).items():
        trainer.aug_cfg = cfg
        draw = trainer.draw(0, tile_idx.shape[1], mosaic, mixup).to("cuda")

        def call():
            return augment_batch_from_pool(draw, *pool, idx, cfg=cfg, max_gt=plan.max_boxes)

        prof = profile_window(call)
        out[name] = dict(mosaic=int(mosaic.sum()), mixup=int(mixup.sum()),
                         device_ms=prof["device_ms"], held_ms=cuda_ms(call, 10),
                         host_ms=host_us(call, 10) / 1e3,
                         launches_per_call=prof.get("launches_per_call"),
                         profile_top=prof.get("top"))
    trainer.aug_cfg = own
    return out if cfgs else out[None]


TRAIN_RUN_EPOCHS = []     # phase 6's epoch records, printed beside phase 9's


def phase_train_run() -> dict:
    """``Trainer.run`` of yolov7 @640 from a plan on the card: 2 epochs with
    the device pool, then a resume from ``.last`` for a third epoch through
    the prefetch thread. Returns the launches of every ``validate_map``."""
    import shutil
    import torch
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.train.checkpoint import train_checkpoint_path
    from yolo_continuous_tpu_torch.train.train_loop import Trainer

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "runs", "chip_smoke_train_run")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rs = np.random.RandomState(0)
    train_ann = write_jpeg_dataset(root, 64, rs, "train")
    val_ann = write_jpeg_dataset(root, 16, rs, "val")
    common = dict(train=train_ann, val=val_ann, batch_size=BS, image_size=SIZE,
                  mosaic_prob=0.5, mixup_prob=0.5, val_map_every=1, save_dir=root + "/",
                  save_name="train_run", seed=0)
    total = {fn.__name__: 0 for fn in counters()}
    records = []

    def run(plan_path):
        trainer = Trainer(TrainPlan(plan_path), device="cuda")
        validate_map = trainer.validate_map

        def counted(state, **kw):
            torch.cuda.synchronize()
            for fn in counters():
                fn.launches = 0
            summary = validate_map(state, **kw)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counters()}
            for name in ("decode_outputs_cuda", "nms_suppress"):
                if launches[name] == 0:
                    fail(f"train_run: validate_map never launched {name}: {launches}")
            for name, n in launches.items():
                total[name] += n
            records.append(dict(launches=launches, **summary))
            return summary

        trainer.validate_map = counted
        torch.cuda.reset_peak_memory_stats()
        logs = []
        state = trainer.run(log=lambda line: (logs.append(line), print(line, flush=True)))
        del trainer.validate_map        # the wrapper refers back to the trainer
        for st in trainer.epoch_stats:
            print(json.dumps({"train_run_epoch": st}), flush=True)
        return trainer, state, logs

    first, state, _ = run(plan_copy(root, "plan_a.yaml", epochs=3, stop_after_epoch=2,
                                    resume="False", device_cache="True", **common))
    if state["step"] != 8:
        fail(f"train_run: {state['step']} steps after 2 epochs of 64 images at batch 16, not 8")
    second, state, logs = run(plan_copy(root, "plan_b.yaml", epochs=3, resume="True",
                                        device_cache="False", **common))
    if "resumed at step 8" not in logs or not any(l.startswith("epoch 3/3 loss") for l in logs):
        fail(f"train_run: the resume from .last did not start at step 8, epoch 3: {logs}")
    if state["step"] != 12 or len(second.epoch_stats) != 1:
        fail(f"train_run: the resumed run ended at step {state['step']}, not 12")
    epochs = first.epoch_stats + second.epoch_stats
    for st in epochs:
        if not np.isfinite(st["loss"]):
            fail(f"train_run: epoch {st['epoch']} loss is not finite: {st['loss']}")
        m = st["map"]
        if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()):
            fail(f"train_run: epoch {st['epoch']} mAP out of [0, 1]: {m}")
    if [st["device_cache"] for st in epochs] != [True, True, False]:
        fail("train_run: device_cache was not on, on, off")
    best = train_checkpoint_path(os.path.join(root, "train_run.msgpack"))
    for path in (best, best + ".last", best + ".bestmap"):
        if not os.path.exists(path):
            fail(f"train_run: {path} was not written")
    if len(records) != 3:
        fail(f"train_run: {len(records)} validate_map calls, not one an epoch")
    augment = augment_alone(second, train_ann)
    del first
    torch.cuda.empty_cache()
    # the killed-and-resumed run against an uninterrupted one, bit for bit
    # (its third epoch from the pool: the pool and the prefetch thread stage
    # the same batches)
    straight = Trainer(TrainPlan(plan_copy(root, "plan_c.yaml", epochs=3, resume="False",
                                           device_cache="True",
                                           **dict(common, save_name="train_run_straight",
                                                  val_map_every=0))),
                       device="cuda").run(log=lambda line: None)
    a, b = flat_state(straight), flat_state(state)
    resume_diff = [k for k in a if not torch.equal(a[k], b[k])]
    if set(a) != set(b) or resume_diff or straight["step"] != state["step"]:
        fail(f"train_run: the resumed run's state differs from the uninterrupted run's in "
             f"{len(resume_diff)} of {len(a)} tensors, e.g. {resume_diff[:5]}")
    del straight, a, b
    print(json.dumps({"train_run": dict(
        config="cfg/coco_train.yaml yolov7 640px bf16 body, batch 16, mosaic_prob 0.5, "
               "mixup_prob 0.5, flip_ud 0.5, 64 train + 16 val JPEGs",
        epochs=[dict({k: st[k] for k in ("epoch", "loss", "step_ms", "augment_ms",
                                         "train_step_ms", "data_wait_ms", "data_wait_ms_steps",
                                         "img_s", "seconds", "device_cache",
                                         "max_memory_allocated")},
                     data_wait_ms_first=st["data_wait_ms_steps"][0],
                     data_wait_ms_later=float(np.mean(st["data_wait_ms_steps"][1:])))
                for st in epochs],
        validate_map=records, resumed_at_step=8, augment_alone=augment,
        resume_bit_equal_to_uninterrupted=True,
        phase_s=time.perf_counter() - t_phase)}), flush=True)
    TRAIN_RUN_EPOCHS[:] = epochs
    del second, state
    torch.cuda.empty_cache()
    return total

# ---------------------------------------------------------------- phase 7

# tests/_torch_port.py's ZOO_BLOCKS (tests/test_zoo_coverage.py's
# SINGLE_INPUT_BLOCKS), ZOO_GROUPS and ZOO_NETS, copied (this script imports
# no test code; tests/test_torch_port_zoo_b.py holds the copies equal)
ZOO_BLOCKS = [
    ("Conv", [16, 3, 1]), ("Conv", [16, 3, 1, None, 1, "nn.LeakyReLU(0.1)"]),
    ("nn.Conv2d", [16, 3, 1]), ("dw_conv", [16, 3, 1]), ("GhostConv", [16, 3, 1]),
    ("RobustConv", [16, 7, 1]), ("RobustConv2", [16, 7, 2]), ("RepConv", [16, 3, 1]),
    ("DownC", [16]), ("SPP", [16]), ("SPPF", [16]), ("SPPCSPC", [16]), ("GhostSPPCSPC", [16]),
    ("Focus", [16, 3]), ("Stem", [16]), ("GhostStem", [16]), ("Bottleneck", [16]),
    ("BottleneckCSPA", [16]), ("BottleneckCSPB", [16]), ("BottleneckCSPC", [16]),
    ("RepBottleneck", [16]), ("RepBottleneckCSPA", [16]), ("RepBottleneckCSPB", [16]),
    ("RepBottleneckCSPC", [16]), ("Res", [16]), ("ResCSPA", [16]), ("ResCSPB", [16]),
    ("ResCSPC", [16]), ("RepRes", [16]), ("RepResCSPA", [16]), ("RepResCSPB", [16]),
    ("RepResCSPC", [16]), ("ResX", [64, True, 8]), ("ResXCSPA", [64, True, 8]),
    ("ResXCSPB", [64, True, 8]), ("ResXCSPC", [64, True, 8]), ("RepResX", [64, True, 8]),
    ("RepResXCSPA", [64, True, 8]), ("RepResXCSPB", [64, True, 8]),
    ("RepResXCSPC", [64, True, 8]), ("Ghost", [16]), ("GhostCSPA", [16]), ("GhostCSPB", [16]),
    ("GhostCSPC", [16]), ("MP", []), ("SP", [3]), ("ReOrg", []), ("Foldcut", []),
    ("Contract", [2]), ("Expand", [2]), ("nn.BatchNorm2d", []),
]
ZOO_GROUPS = {
    "conv": (64, range(0, 8), [["Conv", [16, 3, 1, None, 1, "nn.ReLU()"]],
                               ["Conv", [16, 1, 1, None, 1, "nn.Hardswish()"]],
                               ["Conv", [16, 3, 1, None, 1, "nn.Identity()"]],
                               ["Conv", [16, 1, 1, None, 1, "nn.SiLU()"]]]),
    "spp": (64, range(8, 13), []),
    "stems": (512, range(13, 16), []),
    "bottleneck": (64, range(16, 24), []),
    "res": (64, range(24, 32), []),
    "resx": (64, range(32, 40), []),
    "ghost": (64, list(range(40, 46)) + [50], [["ImplicitA", []], ["ImplicitM", []],
                                                 ["TransformerBlock", [16, 16, 4, 2]]]),
    "reshape": (64, range(46, 50), []),
}
ZOO_NETS = {
    "multi_input": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 1]],
                    [[-1, -2], 1, "Concat", [1]], [[-1, -2], 1, "Chuncat", [1]],
                    [-1, 1, "Conv", [16, 1, 1]], [[-1, 1], 1, "Shortcut", [0]]],
    "repeat": [[-1, 1, "Conv", [16, 3, 2]], [-1, 2, "Bottleneck", [16]],
               [-1, 2, "BottleneckCSPA", [16]]],
}
# the upstream yolov7 P6 anchors (yolov7-w6) and their mask, as
# tests/test_p6_model.py:15-16, 22
P6_ANCHORS = [[19, 27, 44, 40, 38, 94], [96, 68, 86, 152, 180, 137],
              [140, 301, 303, 264, 238, 542], [436, 615, 739, 380, 925, 792]]
P6_MASK = [[9, 10, 11], [6, 7, 8], [3, 4, 5], [0, 1, 2]]
P6_SIZE, P6_TRAIN_BS = 1280, 8
FUSE_TOL = 2e-3             # tests/test_fuse.py's atol for the fused against the train form
ZOO_TOL = 1e-4              # card against CPU, fp32, maps
IBIN_CONF = 0.01            # six steps from random weights score under 0.25


def zoo_net(group: str):
    """(net dict, input size) of a ZOO_GROUPS group (after a 16-channel /2
    stem conv) or a ZOO_NETS net, before a 3-level Detect head."""
    head = [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
            [[-3, -2, -1], 1, "Detect", ["nc", "anchors"]]]
    if group in ZOO_NETS:
        rows, size = [list(r) for r in ZOO_NETS[group]], 64
    else:
        size, idx, extra = ZOO_GROUPS[group]
        rows = [[-1, 1, "Conv", [16, 3, 2]]] + [[-1, 1, n, list(a)] for n, a in
                                                 [ZOO_BLOCKS[i] for i in idx] + extra]
    return {"depth_multiple": 1.0, "width_multiple": 1.0, "backbone": rows, "head": head}, size


def p6_plan():
    """The flagship plan with yolov7-p6-lite, the P6 anchors and mask, 1280 px."""
    plan = random_weights_plan("cfg/net/yolov7-p6-lite.yaml")
    plan.anchors, plan.anchors_mask, plan.image_size = P6_ANCHORS, P6_MASK, P6_SIZE
    return plan


def counted(label, fn, want: dict):
    """Counters to 0, ``fn()``, counters read; every kernel named in ``want``
    must have launched exactly that often (None: at least once)."""
    import torch
    torch.cuda.synchronize()
    for k in counters():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters()}
    for name, n in want.items():
        if (n is None and launches[name] == 0) or (n is not None and launches[name] != n):
            fail(f"{label}: {name} launched {launches[name]} times, not {n or 'at least once'} "
                 f"({launches})")
    return out, launches


def check_request(label, out, nc, bs, conf=CONF):
    import torch
    boxes, scores, classes, valid = out
    if boxes.shape != (bs, 300, 4) or not (torch.isfinite(boxes).all() and
                                           torch.isfinite(scores).all()):
        fail(f"{label}: output {tuple(boxes.shape)} not finite or not (bs, 300, 4)")
    if bool((scores[valid] < conf).any()) or bool((classes[valid] >= nc).any()):
        fail(f"{label}: a detection under the threshold or of an unknown class")


def timed_steps(trainer, state, inputs, n: int = 5):
    """1 warm-up step and ``n`` timed ones (host clock around each, then a
    synchronise); fails unless every loss is finite and num_fg > 0, and the
    parameters and the EMA moved."""
    import torch
    before = flat_state(state)
    torch.cuda.reset_peak_memory_stats()

    def step():
        return trainer.train_step(state, *inputs, 0.01, 0.1, 0.937)[1]

    parts = [step()]
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        parts.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    parts = [{k: float(v) for k, v in p.items()} for p in parts]
    for i, p in enumerate(parts):
        if not all(np.isfinite(v) for v in p.values()) or not p["num_fg"] > 0:
            fail(f"train step {i}: a loss is not finite or num_fg is 0: {p}")
    after = flat_state(state)
    moved = {part: max((after[k].float() - before[k].float()).abs().max().item()
                       for k in before if k.startswith(part + ".") and before[k].is_floating_point())
             for part in ("model", "ema")}
    if not (moved["model"] > 0 and moved["ema"] > 0):
        fail(f"train: the parameters or the EMA did not move: {moved}")
    bs = inputs[0].shape[0]
    return dict(steps=n, step_ms_median=float(np.median(step_ms)), step_ms=step_ms,
                img_s=bs / float(np.median(step_ms)) * 1e3, max_memory_allocated_gb=peak / 2 ** 30,
                first=parts[0], last=parts[-1], num_fg=parts[-1]["num_fg"], moved=moved)


def p6_requests(total) -> dict:
    """yolov7-p6-lite @1280, batch 16: K3 at its 4-level shape, then requests
    counted one by one, stage times, peak memory."""
    import torch
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.kernels.decode import form_for, launch_form
    from yolo_continuous_tpu_torch.ops.decode import decode_level, decode_outputs

    det = Detector(p6_plan(), device="cuda", seed=0)
    spec = det.spec
    rs = np.random.RandomState(7)
    images = torch.from_numpy(rs.rand(BS, P6_SIZE, P6_SIZE, 3).astype("float32")).cuda()
    with torch.inference_mode():
        maps = det.forward(images)
    if len(maps) != 4 or form_for(maps) != "tma":
        fail(f"p6_lite: {len(maps)} head maps in the {form_for(maps)} form, not 4 in tma")

    def kernel(normalized=True, form="tma"):
        return launch_form(maps, spec.anchors, spec.strides, normalized, form)

    def plain(normalized=True):
        return torch.cat([decode_level(m, torch.tensor(a), float(s), normalized)
                          for m, a, s in zip(maps, spec.anchors, spec.strides)], 1)

    got, want = kernel(), plain()
    err = (got - want).abs().max().item()
    if not (got.shape == want.shape and err <= DECODE_TOL):
        fail(f"K3 at 4 levels: max abs err {err} > {DECODE_TOL} (shape {tuple(got.shape)})")
    if not torch.allclose(kernel(False), plain(False), rtol=1e-5, atol=1e-4):
        fail("K3 at 4 levels (pixel mode) disagrees with the plain version")
    check_forms("K3 decode at 4 levels", kernel, maps)
    rows, no = got.shape[1], got.shape[2]
    k3 = dict(shape=[BS, rows, no], levels=[list(m.shape[1:3]) for m in maps], max_abs_err=err,
              ms=cuda_ms(kernel), strided_ms=cuda_ms(lambda: kernel(True, "strided")),
              plain_ms=cuda_ms(plain), bound_ms=2 * BS * rows * no * 4 / HBM_BYTES_S * 1e3,
              bound_by="bytes")
    print(json.dumps({"k3_p6_levels": k3}), flush=True)
    del maps, got, want

    with torch.inference_mode():
        det(images, CONF, IOU, 300)                 # warm cuDNN before the counted requests
        torch.cuda.reset_peak_memory_stats()
        for r in range(3):
            out, launches = counted(f"p6_lite request {r}", lambda: det(images, CONF, IOU, 300),
                                    {"decode_outputs_cuda": 1, "nms_suppress": 1,
                                     "nms_suppress_tiled": 0, "decode_outputs_bin_cuda": 0,
                                     "fused_pointwise_conv_cuda": 0})
            check_request("p6_lite", out, spec.nc, BS)
            for k, n in launches.items():
                total[k] += n
        peak = torch.cuda.max_memory_allocated()
    replay = replay_equal("p6_lite", det, images)
    stages = stage_times(det, images, lambda m: decode_outputs(m, spec.anchors, spec.strides))
    rec = dict(config=f"cfg/coco_train.yaml yolov7-p6-lite {P6_SIZE}px bf16, P6 anchors",
               head=spec.head_name, strides=list(spec.strides), batch=BS, conf=CONF, iou=IOU,
               max_det=300, requests_counted=3, kept_per_image=float(out[3].sum()) / BS,
               max_memory_allocated_gb=peak / 2 ** 30, k3_ms=k3["ms"],
               k3_bound_ms=k3["bound_ms"], replay=replay, **stages)
    print(json.dumps({"p6_lite_requests": rec}), flush=True)
    del det, images
    torch.cuda.empty_cache()
    return k3


def p6_train() -> dict:
    import torch
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    plan = p6_plan()
    plan.batch_size, plan.max_boxes = P6_TRAIN_BS, 64
    plan.save_path = os.path.join(HERE, "runs", "chip_smoke_p6.msgpack")
    trainer = Trainer(plan, device="cuda")
    if trainer.nl != 4 or trainer.spec.head_name != "IAuxDetect":
        fail(f"p6_lite train: {trainer.nl} levels, head {trainer.spec.head_name}")
    state = trainer.init_state(seed=0)
    inputs = train_inputs(np.random.RandomState(0), P6_TRAIN_BS, P6_SIZE, 64, "cuda")
    rec = dict(config=f"yolov7-p6-lite {P6_SIZE}px bf16 body, IAuxDetect aux loss at 4 levels",
               batch=P6_TRAIN_BS, max_boxes=64, **timed_steps(trainer, state, inputs))
    print(json.dumps({"p6_lite_train_step": rec}), flush=True)
    del trainer, state, inputs
    torch.cuda.empty_cache()
    return rec


def ibin_train(total) -> dict:
    """yolov7-IBin @640 trained 1 + 5 steps through bin_yolo_loss, then served
    from its EMA weights: one request, K4 once in its TMA form."""
    import torch
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.kernels.bin_decode import form_for as bin_form_for
    from yolo_continuous_tpu_torch.train.checkpoint import serving_state_dict
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    plan = TrainPlan("cfg/coco_train.yaml")
    plan.model_cfg = ibin_net()
    plan.image_size, plan.batch_size, plan.max_boxes = SIZE, BS, 64
    plan.save_path = os.path.join(HERE, "runs", "chip_smoke_ibin.msgpack")
    trainer = Trainer(plan, device="cuda")
    state = trainer.init_state(seed=0)
    inputs = train_inputs(np.random.RandomState(0), BS, SIZE, 64, "cuda")
    rec = timed_steps(trainer, state, inputs)
    if "bin" not in rec["last"]:
        fail("ibin_train: the step did not go through bin_yolo_loss")
    weights = serving_state_dict({"model": state["model"].state_dict(),
                                  "ema": state["ema"].state_dict()})
    det = Detector(random_weights_plan(ibin_net()), device="cuda", state_dict=weights)
    images = inputs[0]
    with torch.inference_mode():
        if bin_form_for(det.forward(images), det.spec.bin_count) != "tma":
            fail("ibin_train: the trained model's maps do not take K4's TMA form")
        det(images, IBIN_CONF, IOU, 300)
        out, launches = counted("ibin_train request", lambda: det(images, IBIN_CONF, IOU, 300),
                                {"decode_outputs_bin_cuda": 1, "nms_suppress": None,
                                 "decode_outputs_cuda": 0})
    check_request("ibin_train", out, det.spec.nc, BS, IBIN_CONF)
    if not bool(out[3].any()):
        fail("ibin_train: the request served from the EMA weights kept nothing")
    for k, n in launches.items():
        total[k] += n
    rec = dict(config="cfg/coco_train.yaml yolov7-IBin 640px bf16 body", batch=BS,
               max_boxes=64, served_from="EMA", request_conf=IBIN_CONF, request_launches=launches,
               kept_per_image=float(out[3].sum()) / BS,
               replay=replay_equal("ibin_train request", det, images, conf=IBIN_CONF), **rec)
    print(json.dumps({"ibin_train_step": rec}), flush=True)
    del trainer, state, det, inputs
    torch.cuda.empty_cache()
    return rec


def keep_set_difference(out_a, out_b, iou: float = 0.9) -> int:
    """Detections of either request with no detection of the same class at
    IoU >= ``iou`` in the other's keep-set of the same image, over the batch."""
    from yolo_continuous_tpu_torch.ops.boxes import box_iou
    total = 0
    for b in range(out_a[0].shape[0]):
        (ba, ca), (bb, cb) = ((o[0][b][o[3][b]], o[2][b][o[3][b]]) for o in (out_a, out_b))
        hit = (box_iou(ba[None], bb[None])[0] >= iou) & (ca[:, None] == cb[None, :])
        total += int((~hit.any(1)).sum()) + int((~hit.any(0)).sum())
    return total


def gap_and_drift(pred_a, pred_b, k: int):
    """The smallest gap between neighbouring top-(k+1) scores of ``pred_a``
    above the threshold, and the largest score difference of the two: top-k
    ranks alike when the gap exceeds twice the drift."""
    import torch
    sa = pred_a[..., 4] * pred_a[..., 5:].amax(-1)
    sb = pred_b[..., 4] * pred_b[..., 5:].amax(-1)
    top = torch.where(sa >= CONF, sa, -1.0).topk(min(k + 1, sa.shape[-1]), dim=-1).values.double()
    return (top[..., :-1] - top[..., 1:]).min().item(), (sa - sb).abs().max().item()


def fuse_and_head(total, images) -> dict:
    """(fuse) and (head_bf16) of phase 7 on yolov7 @640, batch 16."""
    import torch
    from yolo_continuous_tpu_torch.config.plan import cvt_cfg
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.kernels.decode import form_for
    from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
    from yolo_continuous_tpu_torch.ops.decode import decode_outputs
    from yolo_continuous_tpu_torch.ops.nms import top_candidates
    plan = random_weights_plan()
    spec = build_model_spec(cvt_cfg(plan.model_cfg), plan.image_chan, plan.anchors,
                            plan.num_labels, plan.anchors_mask)
    sd = spread_weights(YoloModel(spec).state_dict(), 3)

    # fp32: the fused form against the train form on the same weights
    plain = Detector(plan, device="cuda", dtype=torch.float32, state_dict=sd)
    fused = Detector(plan, device="cuda", dtype=torch.float32, state_dict=sd, fuse=True)
    left = [k for k in fused.model.state_dict() if ".rbr_dense" in k or ".rbr_1x1" in k
            or ".rbr_identity" in k]
    if left or not any(".rbr_reparam." in k for k in fused.model.state_dict()):
        fail(f"fuse: train-form RepConv keys remain: {left[:3]}")
    with torch.inference_mode():
        mp_, mf = plain.forward(images), fused.forward(images)
        map_err = max((a - b).abs().max().item() for a, b in zip(mp_, mf))
        pp, pf = (decode_outputs(m, spec.anchors, spec.strides) for m in (mp_, mf))
        row_err = (pp - pf).abs().max().item()
        gap, drift = gap_and_drift(pp, pf, 300)
        a, b = plain(images, CONF, IOU, 300), fused(images, CONF, IOU, 300)
    if not (map_err <= FUSE_TOL and row_err <= FUSE_TOL):
        fail(f"fuse fp32: maps differ by {map_err}, rows by {row_err} (tol {FUSE_TOL})")
    va, vb = a[3], b[3]
    with torch.inference_mode():     # the NMS input, sorted: blind to the order of ties
        k = min(300, pp.shape[1])
        top_err = (top_candidates(pp, CONF, k)[1] - top_candidates(pf, CONF, k)[1]).abs().max().item()
    if not top_err <= FUSE_TOL:
        fail(f"fuse fp32: the top-300 candidates' scores differ by {top_err} (tol {FUSE_TOL})")
    if gap > 2 * drift:     # no reordering possible: the detections match one by one
        ok = (torch.equal(va, vb) and (a[0][va] - b[0][va]).abs().max().item() <= FUSE_TOL
              and (a[1][va] - b[1][va]).abs().max().item() <= FUSE_TOL
              and torch.equal(a[2][va], b[2][va]))
        if not ok:
            fail("fuse fp32: detections differ from the unfused Detector's")
        how = "one by one"
    else:                   # greedy NMS may take tied scores in either order
        how = ("not one by one: scores tie within twice the drift among the top 301, so greedy "
               "NMS may order them either way; keep-set difference reported")
    del plain, fused, mp_, mf, pp, pf
    fp32 = dict(map_max_abs_err=map_err, row_max_abs_err=row_err, top300_score_max_abs_err=top_err,
                tol=FUSE_TOL, score_gap=gap, score_drift=drift, detections_compared=how,
                kept=[int(va.sum()), int(vb.sum())], keep_set_difference=keep_set_difference(a, b))

    # bf16: request times in turns; fused tails on the fused form
    dets = {"unfused": Detector(plan, device="cuda", state_dict=sd),
            "fused": Detector(plan, device="cuda", state_dict=sd, fuse=True)}
    turns = {k: [] for k in dets}
    with torch.inference_mode():
        for r in range(4):
            for k in (list(dets) if r % 2 == 0 else list(dets)[::-1]):
                d = dets[k]
                turns[k].append(cuda_ms(lambda: d(images, CONF, IOU, 300), iters=10, warmup=2,
                                        hold=False))
    replays = {"fuse": replay_equal("fuse bf16", dets["fused"], images)}
    tails = Detector(plan, device="cuda", state_dict=sd, fuse=True, fused_tails=True)
    replays["fuse + fused_tails"] = replay_equal("fuse + fused_tails", tails, images)
    with torch.inference_mode():
        tails(images, CONF, IOU, 300)
        out, launches = counted("fuse + fused_tails", lambda: [tails(images, CONF, IOU, 300)
                                                               for _ in range(3)],
                                {"fused_pointwise_conv_cuda": 72, "decode_outputs_cuda": 3,
                                 "nms_suppress": None})
    check_request("fuse + fused_tails", out[-1], tails.spec.nc, BS)
    for k, n in launches.items():
        total[k] += n
    fuse_rec = dict(config="cfg/coco_train.yaml yolov7 640px", batch=BS, fp32=fp32,
                    bf16_request_ms={k: dict(median=float(np.median(v)), turns=v)
                                     for k, v in turns.items()},
                    fused_tails_launches_3_requests=launches, replay=replays)
    print(json.dumps({"fuse": fuse_rec}), flush=True)
    del dets, tails

    # head_dtype bf16 against the fp32 head, bf16 body, same weights
    head32 = Detector(plan, device="cuda", state_dict=sd)
    head16 = Detector(plan, device="cuda", state_dict=sd, head_dtype=torch.bfloat16)
    with torch.inference_mode():
        maps = head16.forward(images)
        if {m.dtype for m in maps} != {torch.bfloat16} or form_for([m.float() for m in maps]) != "tma":
            fail("head_bf16: the maps are not bf16, or cast to fp32 they leave the TMA form")
        head16(images, CONF, IOU, 300)
        out16, launches = counted("head_bf16", lambda: [head16(images, CONF, IOU, 300)
                                                        for _ in range(3)],
                                  {"decode_outputs_cuda": 3, "nms_suppress": None})
        out32 = head32(images, CONF, IOU, 300)
        ms = {k: cuda_ms(lambda: d(images, CONF, IOU, 300), iters=10, warmup=2, hold=False)
              for k, d in (("fp32_head", head32), ("bf16_head", head16))}
    check_request("head_bf16", out16[-1], head16.spec.nc, BS)
    for k, n in launches.items():
        total[k] += n
    replays = {f"bs {bs}": replay_equal(f"head_bf16 bs {bs}", head16, images[:bs])
               for bs in (BS, 1)}
    v16, v32 = out16[-1][3], out32[3]
    head_rec = dict(request_ms=ms, launches_3_requests=launches, replay=replays,
                    keep_set_entries_differing=keep_set_difference(out16[-1], out32),
                    kept_bf16=int(v16.sum()), kept_fp32=int(v32.sum()))
    print(json.dumps({"head_bf16": head_rec}), flush=True)
    del head32, head16, maps
    torch.cuda.empty_cache()
    return dict(fuse=fuse_rec, head_bf16=head_rec)


def reload_check(images) -> dict:
    """reload_weights on running Detectors, with and without fuse."""
    import shutil
    import torch
    from yolo_continuous_tpu_torch.config.plan import cvt_cfg
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
    root = os.path.join(HERE, "runs", "chip_smoke_reload")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    saved = random_weights_plan()
    saved.save_path = os.path.join(root, "saved.msgpack")
    empty = random_weights_plan()
    empty.save_path = os.path.join(root, "missing.msgpack")
    spec = build_model_spec(cvt_cfg(empty.model_cfg), empty.image_chan, empty.anchors,
                            empty.num_labels, empty.anchors_mask)
    torch.save(spread_weights(YoloModel(spec).state_dict(), 5), os.path.join(root, "saved.pth"))
    rec = {}
    for fuse in (False, True):
        det = Detector(empty, device="cuda", seed=0, fuse=fuse)
        with torch.inference_mode():
            before = det(images, CONF, IOU, 300)
            if det.reload_weights() is not False:
                fail(f"reload (fuse={fuse}): a missing checkpoint did not return False")
            if not all(torch.equal(x, y) for x, y in zip(before, det(images, CONF, IOU, 300))):
                fail(f"reload (fuse={fuse}): a failed reload changed the weights")
            if det.reload_weights(saved.save_path) is not True:
                fail(f"reload (fuse={fuse}): the saved checkpoint did not load")
            if det._infer:
                fail(f"reload (fuse={fuse}): the reload kept a captured request")
            got = det(images, CONF, IOU, 300)
            fresh = Detector(saved, device="cuda", fuse=fuse)
            want, eager = fresh(images, CONF, IOU, 300), fresh.infer_eager(images, CONF, IOU, 300)
        for what, ref in (("fresh Detector's replay", want), ("fresh Detector's eager request",
                                                                eager)):
            if differing(got, ref):
                fail(f"reload (fuse={fuse}): the replay after the reload differs from a "
                     f"{what} in {differing(got, ref)}")
        rec[f"fuse={fuse}"] = dict(bit_equal_to_fresh=True, bit_equal_to_fresh_eager=True,
                                   kept=int(got[3].sum()),
                                   changed=not torch.equal(got[1], before[1]))
    print(json.dumps({"reload": rec}), flush=True)
    return rec


def zoo_on_card() -> dict:
    """The zoo's chained rows, the multi-input and repeat nets and YoloBody
    'l' and 'x' at 64 px, fp32, on the card against the CPU; then YoloBody
    'x' at 640, batch 16, bf16, timed."""
    import torch
    from yolo_continuous_tpu_torch.nn.builder import (YoloModel, build_model_spec, init_weights,
                                                      set_dtype)
    from yolo_continuous_tpu_torch.nn.yolo_body import YoloBody
    errs = {}
    nets = list(ZOO_GROUPS) + list(ZOO_NETS) + ["yolobody-l", "yolobody-x"]
    for name in nets:
        if name.startswith("yolobody"):
            model, size = YoloBody(80, name[-1]), 64
        else:
            cfg, size = zoo_net(name)
            model = YoloModel(build_model_spec(cfg, 3, ANCHOR_ROWS, 2))
        gen = torch.Generator().manual_seed(9)
        init_weights(model, gen)
        sd = spread_weights(model.state_dict(), 9)
        with torch.no_grad():          # layer scales and implicit priors near 1, not 1e-6 / 0
            for k in (k for k in sd if k.endswith(("gamma", "implicit"))):
                sd[k].normal_(1.0, 0.1, generator=gen)
        model.eval()
        x = torch.from_numpy(np.random.RandomState(1).rand(2, 3, size, size).astype("float32"))
        with torch.inference_mode():
            want = model(x)
            got = model.cuda()(x.cuda())
        err = max((g.cpu() - w).abs().max().item() for g, w in zip(got, want))
        if len(got) != len(want) or not err <= ZOO_TOL:
            fail(f"zoo {name}: the card's maps differ from the CPU's by {err} (tol {ZOO_TOL})")
        errs[name] = err
        del model
    body = set_dtype(YoloBody(80, "x").cuda().eval(), torch.bfloat16)
    images = torch.rand(BS, 3, SIZE, SIZE, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = cuda_ms(lambda: body(images), iters=5, warmup=2, hold=False)
        maps = body(images)
    if not all(torch.isfinite(m).all() for m in maps):
        fail("YoloBody x @640: the maps are not finite")
    rec = dict(rows=len(ZOO_BLOCKS), nets=nets, max_abs_err=errs, tol=ZOO_TOL,
               yolobody_x_640_bf16_forward_ms=ms, batch=BS,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps({"zoo": rec}), flush=True)
    del body, images, maps
    torch.cuda.empty_cache()
    return rec


def phase_model_zoo():
    """Phase 7; returns the launches of its counted requests and K3's record
    at the P6 shape."""
    import torch
    t_phase = time.perf_counter()
    total = {k.__name__: 0 for k in counters()}
    k3 = p6_requests(total)
    p6_train()
    ibin_train(total)
    images = torch.from_numpy(np.random.RandomState(0).rand(BS, SIZE, SIZE, 3)
                              .astype("float32")).cuda()
    fuse_and_head(total, images)
    reload_check(images)
    zoo_on_card()
    print(json.dumps({"model_zoo": dict(launches=total, phase_s=time.perf_counter() - t_phase)}),
          flush=True)
    return total, k3


# ---------------------------------------------------------------- phase 8

SERVE_MAX_DET = 100        # BatchingEngine's default max_det
SERVE_WAIT_MS = 5.0
SERVE_CLIENTS, SERVE_PER_MODEL, SERVE_URGENT_EVERY = 64, 256, 32
STREAM_FRAMES = 32
# int8 on the card against the CPU, fp32, 64 px: the int32 sums are exact on
# both, but the float ops around them (BN, SiLU, the fp32 head) differ by
# ulps, and an input an ulp either side of a rounding midpoint quantizes one
# step apart; the bar of tests/test_torch_port_quantize.py against JAX
INT8_REL_L2 = 1e-2
# yolov7 @640 int8 Conv shapes held bit for bit against the plain version
# (batch 2: the plain fp64 convolution runs on the CPU)
INT8_CONV_SHAPES = [("stem 3->32 3x3", (2, 3, 640, 640), (32, 3, 3, 3), 1, 1, 1),
                    ("3x3 stride 2, 32->64", (2, 32, 640, 640), (64, 32, 3, 3), 2, 1, 1),
                    ("1x1 1024->512", (2, 1024, 20, 20), (512, 1024, 1, 1), 1, 0, 1),
                    ("3x3 grouped 64->64 g=8", (2, 64, 80, 80), (64, 8, 3, 3), 1, 1, 8)]


def int8_conv_on_card() -> list:
    """The int8 Conv's card routes against the plain version (CPU, fp64) from
    the same x, amax and fp32 weights: int32 sums and outputs bit-equal."""
    import torch
    from yolo_continuous_tpu_torch.nn import quant as Q
    recs = []
    for label, xs, ws, s, p, g in INT8_CONV_SHAPES:
        gen = torch.Generator().manual_seed(sum(xs) + sum(ws))
        x = (torch.randn(xs, generator=gen) * 2).to(torch.bfloat16)
        w = torch.randn(ws, generator=gen) * ws[1] ** -0.5
        sx = Q.activation_scale(x.abs().amax().float() * 0.9)        # some inputs clip
        wq, sw = Q.quantize_weight(w)
        wq_g, sw_g = Q.quantize_weight(w.cuda())
        if not (torch.equal(wq_g.cpu(), wq) and torch.equal(sw_g.cpu(), sw)):
            fail(f"int8 {label}: the weights quantize differently on the card")
        mat = Q.gemm_weight(wq_g) if g == 1 else None
        xg, sxg = x.cuda(), sx.cuda()
        route = Q.route_for(xs, ws, s, p, g)
        got = Q.accumulators_cuda(xg, sxg, wq_g, mat, s, p, g)
        want = Q.accumulators_plain(x, sx, wq, s, p, g)
        if not torch.equal(got.cpu(), want):
            fail(f"int8 {label} ({route}): int32 sums differ from the plain version in "
                 f"{int((got.cpu() != want).sum())} places")
        out = Q.dequantize(got, sxg, sw_g, torch.bfloat16)
        if not torch.equal(out.cpu(), Q.dequantize(want, sx, sw, torch.bfloat16)):
            fail(f"int8 {label} ({route}): outputs differ from the plain version")
        ms = cuda_ms(lambda: Q.dequantize(Q.accumulators_cuda(xg, sxg, wq_g, mat, s, p, g),
                                          sxg, sw_g, torch.bfloat16), iters=5)
        recs.append(dict(shape=label, x=list(xs), route=route, bit_equal=True, ms=ms,
                         max_abs_sum=int(want.abs().max())))
    return recs


def int8_detector_on_card() -> dict:
    """yolov7 @64 Detector(quantize=True), fp32, on the card against the same
    one on the CPU, the CPU's scales on both: maps within INT8_REL_L2, and
    the NMS keep-set of K1 equal to the plain one on the card's rows."""
    import torch
    from yolo_continuous_tpu_torch.config.plan import cvt_cfg
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
    from yolo_continuous_tpu_torch.ops.decode import decode_outputs
    from yolo_continuous_tpu_torch.ops.nms import suppress, suppress_plain, top_candidates
    plan = random_weights_plan()
    plan.image_size = 64
    spec = build_model_spec(cvt_cfg(plan.model_cfg), plan.image_chan, plan.anchors,
                            plan.num_labels, plan.anchors_mask)
    sd = spread_weights(YoloModel(spec).state_dict(), 1)
    kw = dict(dtype=torch.float32, state_dict=sd, quantize=True)
    cpu, gpu = Detector(plan, device="cpu", **kw), Detector(plan, device="cuda", **kw)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype("float32")
    gpu.load_quant_state(cpu.calibrate(x))
    maps_c, maps_g = cpu.forward(x), gpu.forward(x)
    rel = [float((g.cpu().double() - c.double()).norm() / c.double().norm())
           for c, g in zip(maps_c, maps_g)]
    if len(maps_g) != 3 or not max(rel) <= INT8_REL_L2:
        fail(f"int8 yolov7 @64: card maps differ from the CPU's by rel L2 {rel}")
    with torch.inference_mode():
        pred = decode_outputs(maps_g, gpu.spec.anchors, gpu.spec.strides)
        boxes, _, classes, valid = top_candidates(pred, 0.01, min(300, pred.shape[1]))
        keep = suppress(boxes, classes, valid, IOU)
        if not torch.equal(keep, suppress_plain(boxes, classes, valid, IOU)):
            fail("int8 yolov7 @64: K1's keep-set differs from the plain version's")
    return dict(maps_rel_l2=rel, max_abs_diff=max(float((g.cpu() - c).abs().max())
                                                  for c, g in zip(maps_c, maps_g)),
                tol_rel_l2=INT8_REL_L2, valid=int(valid.sum()), kept=int(keep.sum()),
                quantized_convs=len(gpu.model.quant_convs()))


def int8_replays(det, x) -> dict:
    """The int8 request captured against eager after ``calibrate``; after
    ``load_quant_state`` of scales 1.25x as large (the graph is dropped, and
    the replay serves the new scales: other detections); and after loading
    the calibrated scales back (the replay equals the first again)."""
    import torch
    calibrated = det.model.quant_state()
    rec = {"after calibrate": replay_equal("int8 after calibrate", det, x, max_det=SERVE_MAX_DET)}
    with torch.inference_mode():
        first = det(x, CONF, IOU, SERVE_MAX_DET)
    det.load_quant_state({k: v * 1.25 for k, v in calibrated.items()})
    if det._infer:
        fail("int8: load_quant_state kept a captured request")
    rec["after load_quant_state x1.25"] = replay_equal("int8 after load_quant_state", det, x,
                                                       max_det=SERVE_MAX_DET)
    with torch.inference_mode():
        scaled = det(x, CONF, IOU, SERVE_MAX_DET)
        det.load_quant_state(calibrated)
        back = det(x, CONF, IOU, SERVE_MAX_DET)
    if not differing(scaled, first) or differing(back, first):
        fail("int8: the replay after load_quant_state did not serve the scales loaded")
    rec["int8_route_calls_per_replay"] = det._infer[(tuple(x.shape), x.dtype)].launches
    return rec


def serve_images(n: int = 16):
    """``n`` synthetic RGB images from RandomState(0), 640 x 480 and 480 x 640
    in turn (blocky noise with a few filled boxes), their JPEG bytes, and
    the RGB arrays the server decodes from those bytes."""
    import cv2
    rs = np.random.RandomState(0)
    jpegs, rgbs = [], []
    for i in range(n):
        h, w = (480, 640) if i % 2 == 0 else (640, 480)
        img = cv2.resize(rs.randint(0, 256, (h // 16, w // 16, 3)).astype(np.uint8), (w, h))
        for _ in range(4):
            x1, y1 = int(rs.randint(0, w - 64)), int(rs.randint(0, h - 64))
            cv2.rectangle(img, (x1, y1), (x1 + int(rs.randint(32, 200)),
                                          y1 + int(rs.randint(32, 200))),
                          tuple(int(c) for c in rs.randint(0, 256, 3)), -1)
        enc = cv2.imencode(".jpg", img)[1]
        jpegs.append(enc.tobytes())
        rgbs.append(cv2.cvtColor(cv2.imdecode(enc, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
    return jpegs, rgbs


def letterboxed(rgbs):
    """(16, 640, 640, 3) float 0..1 on the card: the images letterboxed as the
    engine letterboxes them, zero rows after them as the engine pads."""
    import torch
    from yolo_continuous_tpu_torch.ops.preprocess import letterbox
    x = np.zeros((BS, SIZE, SIZE, 3), np.float32)
    for i, rgb in enumerate(rgbs):
        x[i] = letterbox(rgb, (SIZE, SIZE), (114, 114, 114))[0].astype(np.float32) / 255.0
    return torch.from_numpy(x).cuda()


def direct_answers(det, rgbs):
    """A direct Detector call on the letterboxed images (a batch of 16, as
    served), mapped to each image's pixels by ``yolo_correct_boxes_np``
    through the engine's ``answers``."""
    import torch
    from yolo_continuous_tpu_torch.serve import answers, detect_rows
    with torch.inference_mode():
        rows = detect_rows(det, letterboxed(rgbs), CONF, IOU, SERVE_MAX_DET)
    return answers(rows, [r.shape[:2] for r in rgbs], (SIZE, SIZE), det.plan.labels)


def http_post(conn, path, body, headers=None, **kw):
    conn.request("POST", path, body=body, headers=headers or {}, **kw)
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def probe(port, model, jpegs) -> list:
    """The answers of ``model`` for ``jpegs``, posted at once, in order."""
    import http.client
    import threading
    out = [None] * len(jpegs)

    def one(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        out[i] = http_post(conn, f"/detect/{model}", jpegs[i])
        conn.close()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(jpegs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (code, body) in enumerate(out):
        if code != 200 or "error" in body:
            fail(f"serve {model}: probe {i} answered {code} {str(body)[:200]}")
    return [body for _, body in out]


def check_answers(label, got, want):
    """Served answers against direct calls: equal bit for bit. The served
    batch and the direct call have the same shape (16), so every kernel and
    cuDNN algorithm is the same, and no image's sums depend on another's."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            fail(f"serve {label}: image {i}'s answer differs from the direct call "
                 f"({len(g['scores'])} against {len(w['scores'])} detections)")


def kept_share(out_a, out_b, iou: float = 0.5):
    """Share of ``out_a``'s kept detections that ``out_b`` keeps too (same
    class, IoU >= ``iou``), over the batch."""
    from yolo_continuous_tpu_torch.ops.boxes import box_iou
    hit = total = 0
    for b in range(out_a[0].shape[0]):
        (ba, ca), (bb, cb) = ((o[0][b][o[3][b]], o[2][b][o[3][b]]) for o in (out_a, out_b))
        total += len(ba)
        if len(ba) and len(bb):
            m = (box_iou(ba[None], bb[None])[0] >= iou) & (ca[:, None] == cb[None, :])
            hit += int(m.any(1).sum())
    return hit / max(total, 1), total


def direct_measurements(dets: dict, x) -> dict:
    """int8 against bf16 on direct calls at batch 16 (before any traffic):
    request ms in 10 alternating turns (host-paced), device ms a batch (stream
    held), peak memory, launches (profiler) and int8 routes a request, and
    the share of bf16's kept detections that int8 keeps."""
    import torch
    from yolo_continuous_tpu_torch.nn import quant as Q
    rec = {name: {} for name in dets}
    with torch.inference_mode():
        turns = {name: [] for name in dets}
        for t in range(10):
            for name in (list(dets) if t % 2 == 0 else list(dets)[::-1]):
                turns[name].append(cuda_ms(lambda: dets[name](x, CONF, IOU, SERVE_MAX_DET),
                                           iters=3, warmup=1, hold=False))
        for name, det in dets.items():
            r = rec[name]
            r["request_ms_turns"] = dict(median=float(np.median(turns[name])),
                                         min=min(turns[name]), max=max(turns[name]))
            r["device_ms_per_batch"] = cuda_ms(lambda: det(x, CONF, IOU, SERVE_MAX_DET), iters=5)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            Q.route_calls.clear()
            det(x, CONF, IOU, SERVE_MAX_DET)
            torch.cuda.synchronize()
            r["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
            r["request_memory_gb"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            r["int8_route_calls"] = dict(Q.route_calls)
            prof = profile_window(lambda: det(x, CONF, IOU, SERVE_MAX_DET), calls=2)
            r["launches_per_request"] = prof.get("launches_per_call")
            r["profile_device_ms"] = prof.get("device_ms")
            r["busy_share"] = prof.get("busy_share")
            r["top_kernels_ms"] = prof.get("top", [])[:6]
        share, n = kept_share(dets["bf16"](x, CONF, IOU, SERVE_MAX_DET),
                              dets["int8"](x, CONF, IOU, SERVE_MAX_DET))
    rec["int8"]["kept_share_of_bf16"] = share
    rec["int8"]["bf16_kept"] = n
    rec["int8"]["quantized_convs"] = len(dets["int8"].model.quant_convs())
    return rec


def serve_traffic(port, jpegs, on_half) -> dict:
    """SERVE_CLIENTS threads, each on its own keep-alive connection, post
    SERVE_PER_MODEL JPEGs to each model (every SERVE_URGENT_EVERY-th urgent),
    in a seeded order; ``on_half`` runs once half of them are answered.
    Meanwhile one /detect/bf16/stream of STREAM_FRAMES frames and one
    chunked /detect/int8 body. Fails on any answer that is not JSON without
    ``error``. Returns what was sent and the window's wall time."""
    import http.client
    import queue
    import struct
    import threading
    rs = np.random.RandomState(1)
    work = [(m, int(rs.randint(len(jpegs))), i % SERVE_URGENT_EVERY == 7)
            for m in ("bf16", "int8") for i in range(SERVE_PER_MODEL)]
    q = queue.Queue()
    for k in rs.permutation(len(work)):
        q.put(work[k])
    errors, lock = [], threading.Lock()
    done = [0]
    half = threading.Event()

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        while True:
            try:
                model, idx, urgent = q.get_nowait()
            except queue.Empty:
                break
            try:
                code, body = http_post(conn, f"/detect/{model}"
                                       + ("?priority=urgent" if urgent else ""), jpegs[idx])
                if code != 200 or "error" in body:
                    raise RuntimeError(f"{code} {str(body)[:200]}")
            except Exception as e:
                with lock:
                    errors.append(f"{model}: {type(e).__name__}: {e}")
            with lock:
                done[0] += 1
                if done[0] == len(work) // 2:
                    half.set()
        conn.close()

    def stream():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        body = b"".join(struct.pack(">I", len(jpegs[i % len(jpegs)])) + jpegs[i % len(jpegs)]
                        for i in range(STREAM_FRAMES))
        conn.request("POST", "/detect/bf16/stream", body=body)
        lines = [json.loads(s) for s in conn.getresponse().read().decode().splitlines()]
        conn.close()
        frames = [ln.get("frame") for ln in lines[:-1]]
        if lines[-1] != {"done": True, "frames": STREAM_FRAMES} or \
                frames != list(range(STREAM_FRAMES)) or any("error" in ln for ln in lines):
            with lock:
                errors.append(f"stream: frames {frames}, last {lines[-1:]}")

    def chunked():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        data = jpegs[0]
        code, body = http_post(conn, "/detect/int8", (data[i:i + 4096]
                                                      for i in range(0, len(data), 4096)),
                               {"Transfer-Encoding": "chunked"}, encode_chunked=True)
        conn.close()
        if code != 200 or "error" in body:
            with lock:
                errors.append(f"chunked: {code} {str(body)[:200]}")

    threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
    threads += [threading.Thread(target=stream), threading.Thread(target=chunked)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if not half.wait(120):
        fail("serve: half of the traffic was not answered in 120 s")
    on_half()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0
    if errors:
        fail(f"serve: {len(errors)} failed requests, e.g. {errors[:3]}")
    sent = {m: sum(1 for w in work if w[0] == m) for m in ("bf16", "int8")}
    sent["bf16"] += STREAM_FRAMES
    sent["int8"] += 1
    urgent = {m: sum(1 for w in work if w[0] == m and w[2]) for m in ("bf16", "int8")}
    return dict(sent=sent, urgent=urgent, wall_s=wall_s)


def traffic_in_child(port, jpegs, root, on_half) -> dict:
    """``serve_traffic`` in a child process (``--serve-clients``), so that
    the clients' threads do not share the server's interpreter lock;
    ``on_half`` runs here when the child reports half of its requests
    answered. The child is waited for, or killed, before this returns."""
    import pickle
    path = os.path.join(root, "jpegs.pkl")
    with open(path, "wb") as f:
        pickle.dump(jpegs, f)
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--serve-clients",
                              str(port), path], stdout=subprocess.PIPE, text=True, cwd=HERE)
    try:
        lines = []
        for line in child.stdout:
            if line.strip() == "HALF":
                on_half()
            else:
                lines.append(line)
        if child.wait(timeout=300) != 0:
            fail(f"serve: the client process exited {child.returncode}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return json.loads(lines[-1])


def serve_clients(port: int, path: str) -> None:
    """The ``--serve-clients`` child: ``serve_traffic`` on the pickled JPEGs,
    "HALF" on a line of its own at half way, the result JSON last."""
    import pickle
    with open(path, "rb") as f:
        jpegs = pickle.load(f)
    res = serve_traffic(port, jpegs, lambda: print("HALF", flush=True))
    print(json.dumps(res), flush=True)


def phase_serve():
    """Phase 8: the serving layer and int8 PTQ serving on the card."""
    import http.client
    import shutil
    import socket
    import threading
    import torch
    from yolo_continuous_tpu_torch.config.plan import cvt_cfg
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.nn import quant as Q
    from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
    from yolo_continuous_tpu_torch.serve import make_multi_server
    from yolo_continuous_tpu_torch.train.checkpoint import save_checkpoint, train_checkpoint_path
    from yolo_continuous_tpu_torch.train.ema import ModelEMA
    t_phase = time.perf_counter()
    rec = dict(int8_conv=int8_conv_on_card(), int8_reference=int8_detector_on_card())
    print(json.dumps({"serve_int8_on_card": rec}), flush=True)

    root = os.path.join(HERE, "runs", "chip_smoke_serve")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    plans = {}
    for name in ("bf16", "int8"):
        plans[name] = random_weights_plan()
        plans[name].save_path = os.path.join(root, f"{name}.msgpack")
    spec = build_model_spec(cvt_cfg(plans["bf16"].model_cfg), 3, plans["bf16"].anchors,
                            plans["bf16"].num_labels, plans["bf16"].anchors_mask)
    weights_a = spread_weights(YoloModel(spec).state_dict(), 11)
    weights_b = spread_weights(YoloModel(spec).state_dict(), 12)
    jpegs, rgbs = serve_images(BS)
    x = letterboxed(rgbs)
    dets = {"bf16": Detector(plans["bf16"], device="cuda", state_dict=weights_a),
            "int8": Detector(plans["int8"], device="cuda", state_dict=weights_a, quantize=True)}
    t0 = time.perf_counter()
    dets["int8"].calibrate(x)                        # 16 synthetic 640 px images
    rec["calibrate_s"] = time.perf_counter() - t0
    rec["replay"] = int8_replays(dets["int8"], x)
    rec["direct"] = direct_measurements(dets, x)
    print(json.dumps({"serve_direct": rec["direct"]}), flush=True)

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    srv = make_multi_server({n: (plans[n], d) for n, d in dets.items()}, port=port,
                            batch_size=BS, max_wait_ms=SERVE_WAIT_MS, conf=CONF, nms=IOU,
                            reload_every=0.25)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        for name in dets:
            check_answers(f"{name} before the traffic", probe(port, name, jpegs[:8]),
                          direct_answers(dets[name], rgbs[:8]))
        before = {n: e.stats() for n, e in srv.engines.items()}
        batch_times = {n: len(e.batch_times) for n, e in srv.engines.items()}

        def reload_b():
            # written as a trainer writes (a temporary file, then a rename), so
            # the watcher never reads half a file
            torch.save(weights_b, os.path.join(root, "bf16.pth.tmp"))
            os.replace(os.path.join(root, "bf16.pth.tmp"), os.path.join(root, "bf16.pth"))
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            code, body = http_post(conn, "/models/bf16/reload", b"")
            conn.close()
            if code != 200 or body.get("reloaded") is not True:
                fail(f"serve: reload answered {code} {body}")

        torch.cuda.synchronize()
        for k in counters():
            k.launches = 0
        traffic = traffic_in_child(port, jpegs, root, reload_b)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in counters()}
        after = {n: e.stats() for n, e in srv.engines.items()}
        batches = sum(after[n]["batches"] - before[n]["batches"] for n in after)
        want = {"decode_outputs_cuda": batches, "nms_suppress": batches,
                "nms_suppress_tiled": 0, "decode_outputs_bin_cuda": 0,
                "fused_pointwise_conv_cuda": 0, "stage_letterbox": 0}
        if launches != want:
            fail(f"serve: launches {launches} over {batches} batches, expected {want} "
                 "(K3 in its TMA form and K1 once a batch)")
        per_model = {}
        for n, e in srv.engines.items():
            a, b = after[n], before[n]
            sent = a["requests"] - b["requests"]
            if sent != traffic["sent"][n] or a["timeouts"] or a["batch_errors"] or \
                    a["reload_errors"]:
                fail(f"serve {n}: stats {a} against {traffic['sent'][n]} requests sent")
            if a["by_priority"].get("urgent", 0) != traffic["urgent"][n]:
                fail(f"serve {n}: {a['by_priority']} urgent, sent {traffic['urgent'][n]}")
            n_b = a["batches"] - b["batches"]
            times = list(e.batch_times)[batch_times[n]:]
            per_model[n] = dict(
                requests=sent, requests_per_s=sent / traffic["wall_s"], batches=n_b,
                mean_batch_fill=sent / n_b, latency_ms=a["latency_ms"],
                host_ms_per_batch=float(np.median([t[0] for t in times])),
                call_ms_per_batch=float(np.median([t[1] for t in times])),
                device_ms_per_batch=rec["direct"][n]["device_ms_per_batch"],
                # the card's busy share if every batch took its direct device time
                device_share_estimate=n_b * rec["direct"][n]["device_ms_per_batch"]
                / (traffic["wall_s"] * 1e3))
        if after["bf16"]["reloads"] < 1:
            fail("serve: the bf16 reload was not counted")

        fresh = Detector(plans["bf16"], device="cuda")            # reads bf16.pth
        check_answers("bf16 after the reload", probe(port, "bf16", jpegs[:8]),
                      direct_answers(fresh, rgbs[:8]))
        check_answers("int8 after the traffic", probe(port, "int8", jpegs[:8]),
                      direct_answers(dets["int8"], rgbs[:8]))
        del fresh

        # the watcher: the port trainer's checkpoint beside the int8 plan
        model = YoloModel(spec)
        model.load_state_dict(weights_b)
        save_checkpoint(train_checkpoint_path(plans["int8"].save_path),
                        {"model": model, "opt": torch.optim.SGD(model.parameters(), lr=0.01),
                         "ema": ModelEMA(model), "step": 1})
        deadline = time.monotonic() + 30
        eng = srv.engines["int8"]
        while eng.stats()["reloads"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        conv = dets["int8"].model.model[0]
        if eng.stats()["reloads"] != 1 or eng.stats()["reload_errors"] or \
                not torch.equal(conv.sw.cpu(), Q.quantize_weight(weights_b["model.0.conv.weight"])[1]):
            fail(f"serve: the watcher did not load the .train.pt: {eng.stats()}")
        rec["watcher"] = dict(reloads=eng.stats()["reloads"], source="int8.train.pt")
    finally:
        srv.shutdown()
        srv.server_close()
        for e in srv.engines.values():
            e.close()
    rec.update(serving=per_model, traffic=traffic, launches_serve=launches,
               phase_s=time.perf_counter() - t_phase)
    print(json.dumps({"serve": {k: rec[k] for k in ("serving", "traffic", "launches_serve",
                                                      "watcher", "calibrate_s", "replay",
                                                      "phase_s")}}),
          flush=True)
    del dets, srv
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 9

PERSP_IMG_TOL = 1e-2      # EnhancePackage card vs CPU on 0..255 (tests/test_torch_port_enhance.py)
REMAT_RTOL = 1e-6         # first step's loss parts and running statistics, remat vs none
REMAT_CASES = [("none", False, None), ("bn_remat", True, None), ("full", False, "full"),
               ("conv", False, "conv"), ("dots", False, "dots")]


def write_voc(root: str, ann_file: str) -> str:
    """VOC XMLs (``tools/gen_anchors.load_voc_boxes`` reads them) of an
    annotation file's boxes, under ``root/Annotations``; returns the dir."""
    import cv2
    out = os.path.join(root, "Annotations")
    os.makedirs(out, exist_ok=True)
    with open(ann_file) as f:
        lines = f.read().split("\n")
    for i, line in enumerate(l for l in lines if l.strip()):
        path, *boxes = line.split()
        h, w = cv2.imread(path).shape[:2]
        objs = "".join(
            "<object><name>c{4}</name><difficult>0</difficult><bndbox><xmin>{0}</xmin>"
            "<ymin>{1}</ymin><xmax>{2}</xmax><ymax>{3}</ymax></bndbox></object>".format(
                *b.split(",")) for b in boxes)
        with open(os.path.join(out, f"im{i:03d}.xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}</height></size>"
                    f"{objs}</annotation>")
    return out


def perspective_run(root: str, total: dict) -> dict:
    """``Trainer.run`` of yolov7 @640 with ``use_perspective`` for one epoch
    from phase 6's plan keys and dataset, ``validate_map`` counted; then one
    pool batch's augmentation with and without the perspective."""
    import torch
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    rs = np.random.RandomState(0)
    train_ann = write_jpeg_dataset(root, 64, rs, "train")
    val_ann = write_jpeg_dataset(root, 16, rs, "val")
    plan_path = plan_copy(root, "plan_persp.yaml", train=train_ann, val=val_ann, batch_size=BS,
                          image_size=SIZE, mosaic_prob=0.5, mixup_prob=0.5, val_map_every=1,
                          save_dir=root + "/", save_name="persp", seed=0, epochs=1,
                          resume="False", device_cache="True", use_perspective="True")
    trainer = Trainer(TrainPlan(plan_path), device="cuda")
    cfg = trainer.aug_cfg
    if not (cfg.use_perspective and (cfg.degrees, cfg.translate, cfg.pscale, cfg.shear)
            == (10, 0.1, 0.1, 10)):
        fail(f"perspective: the plan's AugConfig is {cfg}")
    step, validate_map = trainer.jitted_train_step(), trainer.validate_map
    boxes_out = []

    def train_step(state, images, labels, lmask, *hyper):
        # every valid box inside the canvas: normalized xyxy within [0, 1]
        c, wh = labels[..., 1:3], labels[..., 3:5]
        xyxy = torch.where(lmask[..., None], torch.cat([c - wh / 2, c + wh / 2], -1), 0.5)
        boxes_out.append(torch.stack([xyxy.amin(), xyxy.amax(), lmask.sum().float()]))
        return step(state, images, labels, lmask, *hyper)

    records = []

    def counted(state, **kw):
        torch.cuda.synchronize()
        for fn in counters():
            fn.launches = 0
        summary = validate_map(state, **kw)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters()}
        k3, k1 = launches["decode_outputs_cuda"], launches["nms_suppress"]
        if not (k3 >= 1 and k3 == k1):
            fail(f"perspective: validate_map launched K3 {k3} and K1 {k1} times; the TMA form "
                 "launches K3 once a request, beside one K1")
        for name, n in launches.items():
            total[name] += n
        records.append(dict(launches=launches, **summary))
        return summary

    trainer.jitted_train_step, trainer.validate_map = (lambda: train_step), counted
    torch.cuda.reset_peak_memory_stats()
    trainer.run(log=lambda line: print(line, flush=True))
    del trainer.jitted_train_step, trainer.validate_map     # they refer back to the trainer
    st = trainer.epoch_stats[0]
    if not np.isfinite(st["loss"]) or len(records) != 1:
        fail(f"perspective: epoch loss {st['loss']}, {len(records)} validate_map calls")
    lo, hi, n = torch.stack(boxes_out).cpu().numpy().T
    if not (np.min(lo) >= -1e-6 and np.max(hi) <= 1 + 1e-6 and np.sum(n) > 0):
        fail(f"perspective: a valid box outside the canvas: min {np.min(lo)}, max {np.max(hi)}")
    alone = augment_alone(trainer, train_ann, {"with": cfg,
                                               "without": cfg._replace(use_perspective=False)})
    rec = dict(epoch={k: st[k] for k in ("loss", "step_ms", "augment_ms", "train_step_ms",
                                         "img_s", "max_memory_allocated")},
               phase6_epochs=[{k: e.get(k) for k in ("epoch", "step_ms", "augment_ms",
                                                     "train_step_ms")} for e in TRAIN_RUN_EPOCHS]
               or "phase 6 not run", boxes_in_canvas=dict(min=float(np.min(lo)),
                                                          max=float(np.max(hi)),
                                                          valid=int(np.sum(n))),
               validate_map=records, augment_alone=alone,
               augment_added_ms=alone["with"]["held_ms"] - alone["without"]["held_ms"])
    return trainer, rec


def enhance_package_card_vs_cpu() -> dict:
    """``EnhancePackage`` with the perspective on 16 images of 640 x 480, on
    the card and on the CPU from the same draws."""
    import torch
    from yolo_continuous_tpu_torch.ops.enhance import EnhancePackage
    rs = np.random.RandomState(5)
    img = rs.randint(0, 256, (BS, 480, 640, 3)).astype(np.float32)
    boxes = np.zeros((BS, 8, 5), np.float32)
    for i in range(8):
        x, y = rs.uniform(0, 500, BS), rs.uniform(0, 360, BS)
        boxes[:, i] = np.stack([x, y, x + rs.uniform(20, 140, BS), y + rs.uniform(20, 120, BS),
                                np.full(BS, i)], -1)
    mask = np.ones((BS, 8), bool)
    from yolo_continuous_tpu_torch.config.plan import cvt_cfg
    cfg = dict(cvt_cfg("cfg/enhance/enhance.yaml"), equalize=0.5, scale_fill=0.5)
    pkg = EnhancePackage(SIZE, cfg, use_perspective=True)
    draw = pkg.draw(torch.Generator().manual_seed(6), BS, 480, 640)
    cpu = pkg(draw, *map(torch.from_numpy, (img, boxes, mask)))
    args = [torch.from_numpy(a).cuda() for a in (img, boxes, mask)]
    card = pkg(draw.to("cuda"), *args)
    img_err = float((card[0].cpu() - cpu[0]).abs().max())
    if img_err > PERSP_IMG_TOL or not torch.equal(card[2].cpu(), cpu[2]):
        fail(f"EnhancePackage card vs CPU: images {img_err} (tol {PERSP_IMG_TOL}) or masks differ")
    box_err = float((card[1].cpu() - cpu[1]).abs().max())
    if box_err > 0:
        fail(f"EnhancePackage card vs CPU: boxes differ by {box_err}")
    ms = cuda_ms(lambda: pkg(draw.to("cuda"), *args), iters=5, hold=False)
    return dict(images=BS, size="640x480 -> 640", max_abs_err=img_err, tol=PERSP_IMG_TOL,
                boxes="bit-equal", kept=int(cpu[2].sum()), ms=ms)


def bn_buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items() if "running_" in k}


def launches_of(fn) -> int:
    """Device kernels and copies that one call of ``fn`` launches, from a
    profiler window that records device activity only (no CPU ops: a
    fraction of ``profile_window``'s cost on a 10,000-launch train step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def remat_steps(inputs) -> dict:
    """The compiled step (``Trainer.jitted_train_step()``) of yolov7 @640,
    batch 16, 1 + 5 steps under no remat, ``bn_remat`` and each ``remat``
    policy, the checkpoints' recomputation inside the graph: step ms, peak
    memory, launches a step, warm-up and capture ms and the pool; the first
    step (the warm-up, eager) against the plain step's loss parts and
    running statistics."""
    import torch
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    out, base, weights0 = {}, None, None
    for name, bn_remat, remat in REMAT_CASES:
        t_case = time.perf_counter()
        plan = TrainPlan("cfg/coco_train.yaml")
        plan.image_size, plan.batch_size, plan.max_boxes = SIZE, BS, 64
        plan.cfg = dict(plan.cfg, bn_remat=bn_remat)
        trainer = Trainer(plan, device="cuda", remat=remat)
        state = trainer.init_state(seed=0, state_dict=weights0)
        weights0 = weights0 or {k: v.detach().cpu().clone()
                                for k, v in trainer.model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step = trainer.jitted_train_step()          # the first call: warm-up and capture
        first = {k: v.clone() for k, v in step(state, *inputs, 0.01, 0.1, 0.937)[1].items()}
        running, weights = bn_buffers(trainer.model), flat_state(state)
        peak = torch.cuda.max_memory_allocated()
        (call,) = trainer._graphs.values()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            step(state, *inputs, 0.01, 0.1, 0.937)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = launches_of(lambda: step(state, *inputs, 0.01, 0.1, 0.937))
        rec = dict(step_ms_median=float(np.median(times)), step_ms=times,
                   peak_memory_gb=peak / 2 ** 30, launches_per_step=launches,
                   captured=dict(warmup_ms=call.warmup_ms, capture_ms=call.capture_ms,
                                 pool_gib=call.pool_bytes / 2 ** 30),
                   first={k: float(v) for k, v in first.items()})
        if base is None:
            base = dict(first=first, running=running, weights=weights)
        else:
            parts = max(float(((first[k].double() - base["first"][k].double()).abs()
                               / base["first"][k].double().abs().clamp(min=1e-30)).max())
                        for k in first)
            stats = max(float(((running[k].double() - v.double()).abs()
                               / v.double().abs().clamp(min=1e-12)).max())
                        for k, v in base["running"].items())
            if parts > REMAT_RTOL or stats > REMAT_RTOL:
                fail(f"remat {name}: first step's loss parts ({parts}) or running statistics "
                     f"({stats}) differ from no remat beyond rtol {REMAT_RTOL}")
            rec.update(loss_parts_rel_err=parts, running_stats_rel_err=stats, rtol=REMAT_RTOL,
                       loss_and_stats_bit_equal=all(torch.equal(first[k], base["first"][k])
                                                    for k in first)
                       and all(torch.equal(running[k], v) for k, v in base["running"].items()),
                       weights_rel_l2=rel_l2({k: weights[k] for k in base["weights"]
                                              if base["weights"][k].is_floating_point()},
                                             {k: v.cpu() for k, v in base["weights"].items()
                                              if v.is_floating_point()}))
        rec["seconds"] = time.perf_counter() - t_case
        out[name] = rec
        print(f"remat {name}: {rec['step_ms_median']:.1f} ms a step, "
              f"{rec['peak_memory_gb']:.2f} GB", flush=True)
        del trainer, state, weights
        torch.cuda.empty_cache()
    return out, weights0


def mesh_step(inputs, weights0) -> dict:
    """A world of one through NCCL: ``initialize``, ``make_mesh(1, 1)``,
    ``shard_params``, ``shard_batch`` and ``train_step`` bit-equal to the
    unmeshed step (cuDNN in its deterministic mode for the three runs: its
    default weight-gradient algorithms sum with atomics, so two plain steps
    differ in the last bits); step ms between two plain runs; the group
    destroyed."""
    import socket
    import torch
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.parallel import distributed as dist
    from yolo_continuous_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    dist.initialize(f"localhost:{port}", 1, 0, device="cuda", timeout_s=120)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        if torch.distributed.get_backend() != "nccl":
            fail(f"mesh: the group's backend is {torch.distributed.get_backend()}, not nccl")
        mesh = make_mesh(1, 1)
        init_s = time.perf_counter() - t0
        plan = TrainPlan("cfg/coco_train.yaml")
        plan.image_size, plan.batch_size, plan.max_boxes = SIZE, BS, 64
        times, base = {}, None
        for label, m in (("plain", None), ("mesh", mesh), ("plain_again", None)):
            trainer = Trainer(plan, device="cuda", mesh=m)
            state = trainer.init_state(state_dict=weights0)
            batch = inputs
            if m is not None:
                shard_params(m, state)
                batch = shard_batch(m, inputs)
            first = trainer.train_step(state, *batch, 0.01, 0.1, 0.937)[1]
            after = flat_state(state)
            if base is None:
                base = dict(first=first, weights=after)
            else:
                if not all(torch.equal(first[k], base["first"][k]) for k in first):
                    fail(f"mesh: the {label} step's loss parts {first} differ from the "
                         f"plain step's {base['first']}")
                bad = [k for k, v in base["weights"].items() if not torch.equal(after[k], v)]
                if bad:
                    fail(f"mesh: {len(bad)} state tensors of the {label} step differ from the "
                         f"plain step's, e.g. {bad[:3]}")
            ms = []
            for _ in range(5):
                t1 = time.perf_counter()
                trainer.train_step(state, *batch, 0.01, 0.1, 0.937)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
            times[label] = dict(step_ms_median=float(np.median(ms)), step_ms=ms)
            if label != "plain_again":
                times[label]["launches_per_step"] = launches_of(
                    lambda: trainer.train_step(state, *batch, 0.01, 0.1, 0.937))
            del trainer, state, after
        return dict(backend="nccl", world=1, layout="1 x 1", init_s=init_s,
                    bit_equal="loss parts and every state tensor, cudnn.deterministic", **times)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.shutdown()
        torch.cuda.empty_cache()


def tools_check(root: str, trainer, total: dict) -> dict:
    """``gen_anchors`` on the phase's annotation file (as VOC XMLs), and
    ``torch_export`` of the phase's ``.train.pt``: a Detector on the ``.pth``
    against a Detector on the ``.train.pt``, bit for bit on 16 images."""
    import cv2
    import torch
    from yolo_continuous_tpu_torch.detect_api import Detector, weights_source
    from yolo_continuous_tpu_torch.ops.preprocess import letterbox
    from yolo_continuous_tpu_torch.tools.gen_anchors import gen_anchors
    from yolo_continuous_tpu_torch.tools.torch_export import export_checkpoint
    from yolo_continuous_tpu_torch.train.checkpoint import (load_checkpoint, serving_state_dict,
                                                            train_checkpoint_path)
    plan = trainer.plan
    voc = write_voc(root, os.path.join(root, "train.txt"))
    anchors = gen_anchors(voc, (SIZE, SIZE), 9, os.path.join(root, "anchors.txt"), seed=0)
    areas = anchors[:, 0] * anchors[:, 1]
    if anchors.shape != (9, 2) or not (anchors > 0).all() or (np.diff(areas) < 0).any():
        fail(f"gen_anchors: {anchors}")
    ckpt = train_checkpoint_path(plan.save_path)
    pth = os.path.splitext(plan.save_path)[0] + ".pth"
    sd = export_checkpoint(plan, pth)
    if weights_source(plan.save_path) != pth:
        fail(f"torch_export: the Detector would not read {pth}")
    with open(os.path.join(root, "val.txt")) as f:
        paths = [line.split()[0] for line in f if line.strip()][:BS]
    images = torch.from_numpy(np.stack([letterbox(cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB),
                                                  SIZE)[0] for p in paths]).astype(np.float32)
                              / 255.0).cuda()
    dets = {"pth": Detector(plan, device="cuda"),
            "train_pt": Detector(plan, device="cuda",
                                 state_dict=serving_state_dict(load_checkpoint(ckpt)))}
    outs = {}
    for name, det in dets.items():
        det(images, 0.01, IOU, 300)
        torch.cuda.synchronize()
        for fn in counters():
            fn.launches = 0
        outs[name] = det(images, 0.01, IOU, 300)
        torch.cuda.synchronize()
        for fn in counters():
            total[fn.__name__] += fn.launches
    if not all(torch.equal(a, b) for a, b in zip(outs["pth"], outs["train_pt"])):
        fail("torch_export: the Detector on the .pth differs from the one on the .train.pt")
    return dict(anchors=anchors.round(2).tolist(), exported_tensors=len(sd),
                kept=int(outs["pth"][3].sum()), detections="bit-equal (conf 0.01, 16 images)")


def phase_parallel_and_tools():
    """Phase 9: the perspective, remat, the mesh and the tools, at full width."""
    import shutil
    import torch
    t_phase = time.perf_counter()
    root = os.path.join(HERE, "runs", "chip_smoke_parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    total = {fn.__name__: 0 for fn in counters()}
    rec = {}
    t0 = time.perf_counter()
    trainer, rec["perspective"] = perspective_run(root, total)
    rec["perspective"]["seconds"] = time.perf_counter() - t0
    rec["enhance_package"] = enhance_package_card_vs_cpu()
    t0 = time.perf_counter()
    inputs = train_inputs(np.random.RandomState(0), BS, SIZE, 64, "cuda")
    rec["remat"], weights0 = remat_steps(inputs)
    rec["remat_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["mesh"] = mesh_step(inputs, weights0)
    rec["mesh"]["seconds"] = time.perf_counter() - t0
    rec["tools"] = tools_check(root, trainer, total)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    rec.update(launches_parallel=total, phase_s=time.perf_counter() - t_phase,
               config="cfg/coco_train.yaml yolov7 640px bf16 body, batch 16",
               card=smi.stdout.strip())
    print(json.dumps({"parallel_and_tools": rec}), flush=True)
    del trainer
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------- phase 10

# (w, h) of the stager's check at S = 640: landscape and portrait photos,
# 720p, 1080p, an odd size, JAX's fp32 width case (nw = 639) and 1 x 1
STAGER_SIZES = ((640, 480), (480, 640), (1280, 720), (1920, 1080), (333, 517), (133, 65), (1, 1))
GRAIN = 8                   # levels of luma noise in the phase's photo-like JPEGs


def stager_files(root: str, rs) -> list:
    """One photo-like JPEG of each of STAGER_SIZES and a grayscale one."""
    import cv2
    paths = []
    for w, h in STAGER_SIZES:
        paths.append(os.path.join(root, f"size_{w}x{h}.jpg"))
        cv2.imwrite(paths[-1], photo_like(rs, w, h, GRAIN)[0] if w > 12 else
                    rs.randint(0, 255, (h, w, 3)).astype(np.uint8))
    paths.append(os.path.join(root, "gray_640x480.jpg"))
    cv2.imwrite(paths[-1], cv2.cvtColor(photo_like(rs, 640, 480, GRAIN)[0], cv2.COLOR_RGB2GRAY))
    return paths


def stager_against_plain(paths) -> dict:
    """``stage_letterbox`` against its plain version on the same decoded
    pixels (on the CPU, copied down, and on the card), bit-equal at S = 640;
    then ``stage_batch_native`` end to end, the card's against the CPU's
    (one decode, so tiles, metas and ``ok`` bit-equal)."""
    import torch
    from yolo_continuous_tpu_torch.data.native_loader import stage_batch_native
    from yolo_continuous_tpu_torch.kernels import staging
    dec = staging.decode(staging.read_files(paths), "cuda")
    if not dec.ok.all():
        fail(f"native_staging: the decode refused {[p for p, ok in zip(paths, dec.ok) if not ok]}")
    geo = torch.tensor([staging.canvas_row(dec, i, SIZE, 128)[0] for i in range(len(paths))])
    got = staging.stage_letterbox(dec.src, geo.cuda(), SIZE).cpu()
    on_cpu = staging.stage_letterbox_plain(dec.src.cpu(), geo, SIZE)
    on_card = staging.stage_letterbox_plain(dec.src, geo, SIZE).cpu()
    err = int((got.int() - on_cpu.int()).abs().max())
    if not (torch.equal(got, on_cpu) and torch.equal(got, on_card)):
        fail(f"native_staging: stage_letterbox differs from its plain version by {err}")
    card, cpu = stage_batch_native(paths, SIZE, 128, "cuda"), stage_batch_native(paths, SIZE, 128,
                                                                                 "cpu")
    end_to_end = int((torch.as_tensor(card[0]).cpu().int()
                      - torch.from_numpy(cpu[0]).int()).abs().max())
    if end_to_end or not (np.array_equal(card[1], cpu[1]) and np.array_equal(card[2], cpu[2])):
        fail(f"native_staging: the card's stage_batch_native differs from the CPU's: tiles by "
             f"{end_to_end}, metas {card[1]} against {cpu[1]}")
    return dict(files=[os.path.basename(p) for p in paths], bit_equal=True, max_abs_err=err,
                end_to_end_max_abs_err=end_to_end, metas_equal=True)


def batch_geometry(paths) -> tuple:
    """The decoded pixels and geometry table that ``YoloDataset`` hands
    ``stage_letterbox`` for one training batch of ``paths``: BS samples x 4
    tile slots at mosaic 0.5, so the unused slots of the samples that do not
    take a mosaic are rows of fill 0."""
    import types
    from yolo_continuous_tpu_torch.data import native_loader
    from yolo_continuous_tpu_torch.data.dataset import Annotation, YoloDataset
    from yolo_continuous_tpu_torch.kernels import staging
    ds = YoloDataset([Annotation(p, np.zeros((0, 5), np.float32)) for p in paths], SIZE, 64,
                     mosaic_prob=0.5, device="cuda")
    ds.reseed(0)
    seen = []

    def capture(src, geo, size, out=None):
        seen.append((src, geo.clone()))
        return staging.stage_letterbox(src, geo, size, out)

    # the stager as native_loader sees it, with the kernel's wrapper behind capture
    native_loader.staging = types.SimpleNamespace(**{**vars(staging), "stage_letterbox": capture})
    try:
        tiles = ds.batch(list(range(BS)))[0]
    finally:
        native_loader.staging = staging
    (src, geo), = seen
    fill_rows = int((geo[:, 3] == 0).sum())
    if tuple(tiles.shape[:2]) != (BS, 4) or not 0 < fill_rows < geo.shape[0]:
        fail(f"native_staging: the training batch staged {tuple(tiles.shape)} with "
             f"{fill_rows} fill rows of {geo.shape[0]}")
    return src, geo, fill_rows


def stager_alone(paths) -> dict:
    """A mosaic batch of 64 JPEGs of 640 x 480 through the card's stager:
    decode, kernel (device time beside its byte bound), host and images/s,
    against cv2's ``stage_image`` on the same files in alternating turns.
    The kernel is held bit-equal to its plain version on that batch and on
    a training batch of the same files (``batch_geometry``)."""
    import torch
    from yolo_continuous_tpu_torch.data.dataset import _read_rgb
    from yolo_continuous_tpu_torch.data.native_loader import stage_batch_native
    from yolo_continuous_tpu_torch.kernels import staging
    from yolo_continuous_tpu_torch.ops.preprocess import stage_image
    n = len(paths)
    for _ in range(2):                                      # the decoder's buffers grow once
        stage_batch_native(paths, SIZE, 128, "cuda")
    torch.cuda.synchronize()
    read_ms, decode_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        data = staging.read_files(paths)
        t1 = time.perf_counter()
        dec = staging.decode(data, "cuda")
        torch.cuda.synchronize()
        read_ms.append((t1 - t0) * 1e3)
        decode_ms.append((time.perf_counter() - t1) * 1e3)
    geo = torch.tensor([staging.canvas_row(dec, i, SIZE, 128)[0] for i in range(n)]).cuda()
    out = torch.empty((n, SIZE, SIZE, 3), dtype=torch.uint8, device=dec.src.device)
    plain_out = torch.empty_like(out)
    kernel_ms = cuda_ms(lambda: staging.stage_letterbox(dec.src, geo, SIZE, out))
    plain_ms = cuda_ms(lambda: staging.stage_letterbox_plain(dec.src, geo, SIZE, plain_out),
                       iters=2, warmup=1, hold=False)
    if not torch.equal(out, plain_out):
        fail(f"native_staging: stage_letterbox differs from its plain version on the batch of "
             f"{n} by {int((out.int() - plain_out.int()).abs().max())}")
    src, bgeo, fill_rows = batch_geometry(paths)
    got = staging.stage_letterbox(src, bgeo, SIZE)
    want = staging.stage_letterbox_plain(src, bgeo, SIZE)
    if not torch.equal(got, want):
        fail(f"native_staging: stage_letterbox differs from its plain version on a training "
             f"batch ({fill_rows} fill rows) by {int((got.int() - want.int()).abs().max())}")
    batch_ms = cuda_ms(lambda: staging.stage_letterbox(src, bgeo, SIZE, got))
    decoded = int((dec.dims[:, 0] * dec.dims[:, 1]).sum()) * 3
    moved = decoded + n * SIZE * SIZE * 3 + geo.numel() * 8
    images = {tuple(r[:3]) for r in bgeo[bgeo[:, 3] > 0].tolist()}     # each file once
    batch_moved = (sum(iw * ih * 3 for _, iw, ih in images) + bgeo.shape[0] * SIZE * SIZE * 3
                   + bgeo.numel() * 8)
    turns = []
    for _ in range(5):
        t0 = time.perf_counter()
        stage_batch_native(paths, SIZE, 128, "cuda")
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        native = time.perf_counter() - t0
        t0 = time.perf_counter()
        for p in paths:
            stage_image(_read_rgb(p), SIZE)
        turns.append(dict(native_host_ms=host * 1e3, native_ms=native * 1e3,
                          cv2_ms=(time.perf_counter() - t0) * 1e3))
    med = {k: float(np.median([t[k] for t in turns])) for k in turns[0]}
    return dict(images=n, size="640x480", read_ms=float(np.median(read_ms)),
                decode_ms=float(np.median(decode_ms)), kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=moved / HBM_BYTES_S * 1e3, bytes_moved=moved, bit_equal=True,
                training_batch=dict(canvases=int(bgeo.shape[0]), fill_rows=fill_rows,
                                    kernel_ms=batch_ms, bound_ms=batch_moved / HBM_BYTES_S * 1e3,
                                    bit_equal=True),
                host_ms=med["native_host_ms"], native_ms=med["native_ms"], cv2_ms=med["cv2_ms"],
                native_img_s=n / med["native_ms"] * 1e3, cv2_img_s=n / med["cv2_ms"] * 1e3,
                turns=turns)


def odd_files(root: str, rs, ann: str) -> None:
    """A grayscale JPEG and a PNG named ``.jpg`` (the stager refuses it, as
    libjpeg does; the dataset stages it with cv2) appended to the annotation
    file ``ann``."""
    import cv2
    img, boxes = photo_like(rs, 640, 480, GRAIN)
    gray = os.path.join(root, "odd_gray.jpg")
    cv2.imwrite(gray, cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    png = os.path.join(root, "odd_png.jpg")
    cv2.imwrite(os.path.join(root, "odd.png"), img)
    os.replace(os.path.join(root, "odd.png"), png)
    with open(ann, "a") as f:
        f.write(" ".join([gray] + boxes) + "\n" + " ".join([png] + boxes) + "\n")


def data_layer_turns(trainer, ann: str, pairs: int = 3) -> dict:
    """One epoch of the train loader's staging (``Trainer._staged_batches``,
    as the prefetch thread runs it) through the card's stager and through cv2
    (``use_native=False``), in alternating turns: seconds an epoch."""
    import torch
    from yolo_continuous_tpu_torch.data.dataset import YoloDataset, load_annotation_file
    plan = trainer.plan
    out = {"native": [], "cv2": []}
    for _ in range(pairs):
        for name in ("native", "cv2"):
            ds = YoloDataset(load_annotation_file(ann), plan.image_size, plan.max_boxes,
                             plan.mosaic, plan.mixup, plan.mosaic_prob, plan.mixup_prob,
                             plan.epochs, plan.special_aug_ratio, seed=plan.seed,
                             use_native=name == "native", device="cuda")
            ds.reseed(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batches = sum(1 for _ in trainer._staged_batches(ds))
            torch.cuda.synchronize()
            out[name].append(time.perf_counter() - t0)
    return dict(batches=batches, native_s=out["native"], cv2_s=out["cv2"],
                native_s_median=float(np.median(out["native"])),
                cv2_s_median=float(np.median(out["cv2"])))


def pool_turns(ann: str, pairs: int = 2) -> dict:
    """``staged_pool`` of the dataset through the card's stager and through
    cv2, in alternating turns: seconds."""
    import torch
    from yolo_continuous_tpu_torch.data.dataset import YoloDataset, load_annotation_file
    out = {"native": [], "cv2": []}
    for _ in range(pairs):
        for name in ("native", "cv2"):
            ds = YoloDataset(load_annotation_file(ann), SIZE, 64, use_native=name == "native",
                             device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool = ds.staged_pool()
            torch.cuda.synchronize()
            out[name].append(time.perf_counter() - t0)
    return dict(images=int(pool[0].shape[0]), native_s=out["native"], cv2_s=out["cv2"])


def phase_native_staging():
    """Phase 10: the native JPEG stager, and ``Trainer.run`` through it
    without the device pool. Returns (launches of the run, the stager's row
    for the kernels line)."""
    import shutil
    import cv2
    import torch
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.data import dataset as pds
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    t_phase = time.perf_counter()
    root = os.path.join(HERE, "runs", "chip_smoke_native")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rs = np.random.RandomState(10)
    rec = {"against_plain": stager_against_plain(stager_files(root, rs))}
    mosaic_files = []
    for i in range(64):
        mosaic_files.append(os.path.join(root, f"mosaic{i:02d}.jpg"))
        cv2.imwrite(mosaic_files[-1], photo_like(rs, 640, 480, GRAIN)[0])
    rec["stager_alone"] = alone = stager_alone(mosaic_files)

    shapes = ((480, 640), (640, 480)) * 15 + ((720, 1280),) * 2
    train_ann = write_jpeg_dataset(root, 256, rs, "train", shapes, GRAIN)
    odd_files(root, rs, train_ann)
    val_ann = write_jpeg_dataset(root, 32, rs, "val", shapes, GRAIN)
    plan_path = plan_copy(root, "plan.yaml", train=train_ann, val=val_ann, batch_size=BS,
                          image_size=SIZE, mosaic_prob=0.5, mixup_prob=0.5, val_map_every=1,
                          save_dir=root + "/", save_name="native", seed=0, epochs=1,
                          resume="False", device_cache="False")
    trainer = Trainer(TrainPlan(plan_path), device="cuda")
    fallbacks = []
    staged = pds.YoloDataset._staged

    def counted_fallback(ds, idx):
        fallbacks.append(os.path.basename(ds.annotations[idx].path))
        return staged(ds, idx)

    pds.YoloDataset._staged = counted_fallback
    torch.cuda.synchronize()
    for fn in counters():
        fn.launches = 0
    try:
        logs = []
        state = trainer.run(log=lambda line: (logs.append(line), print(line, flush=True)))
        torch.cuda.synchronize()
    finally:
        pds.YoloDataset._staged = staged
    launches = {fn.__name__: fn.launches for fn in counters()}
    (st,) = trainer.epoch_stats
    if st["device_cache"] or state["step"] != 258 // BS or not np.isfinite(st["loss"]):
        fail(f"native_staging: the epoch without the pool ran {state['step']} steps, "
             f"loss {st['loss']}, device_cache {st['device_cache']}")
    for name in ("stage_letterbox", "decode_outputs_cuda", "nms_suppress"):
        if launches[name] == 0:
            fail(f"native_staging: Trainer.run never launched {name}: {launches}")
    m = st["map"]
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in m.values()):
        fail(f"native_staging: mAP out of [0, 1]: {m}")
    if "odd_png.jpg" not in fallbacks:
        fail(f"native_staging: the PNG named .jpg was not staged by cv2: {fallbacks}")
    rec["train_run"] = dict(
        config="cfg/coco_train.yaml yolov7 640px bf16 body, batch 16, mosaic_prob 0.5, "
               "mixup_prob 0.5, device_cache false, 258 train + 32 val JPEGs",
        launches=launches, cv2_fallbacks=len(fallbacks), fallback_files=sorted(set(fallbacks)),
        **{k: st[k] for k in ("loss", "steps", "seconds", "step_ms", "augment_ms",
                              "train_step_ms", "data_wait_ms", "data_wait_ms_steps", "img_s",
                              "max_memory_allocated")},
        data_wait_ms_first=st["data_wait_ms_steps"][0],
        data_wait_ms_later=float(np.mean(st["data_wait_ms_steps"][1:])), map=m)
    rec["data_layer"] = data_layer_turns(trainer, train_ann)
    rec["staged_pool"] = pool_turns(train_ann)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    rec.update(phase_s=time.perf_counter() - t_phase, card=smi.stdout.strip())
    print(json.dumps({"native_staging": rec}), flush=True)
    row = dict(max_abs_err=float(rec["against_plain"]["max_abs_err"]), ms=alone["kernel_ms"],
               plain_ms=alone["plain_ms"], bound_ms=alone["bound_ms"], bound_by="bytes",
               library_ms=None, decode_ms=alone["decode_ms"])
    del trainer, state
    torch.cuda.empty_cache()
    return launches, row


# ---------------------------------------------------------------- phase 11

# the port's bench as the smoke test runs it: every section and lever of the
# JAX bench, within a budget that keeps the whole script inside its limit
BENCH_ENV = {"BENCH_INFER_EXTRAS": "fused_tails,int8", "BENCH_TRAIN_MODES": "base,bn_remat",
             "BENCH_TOTAL_BUDGET": "600", "BENCH_INFER_RESERVE": "240"}
BENCH_KEYS = ("value", "infer_img_s", "infer_1_ms", "nms_p50_ms", "infer_1_ms_fused_tails",
              "infer_img_s_int8")


def run_bench() -> tuple:
    """``python -m yolo_continuous_tpu_torch.bench 16`` in its own process
    (which starts one a section) under ``BENCH_ENV``; returns its last line
    and its ``[bench passes]`` records. Past its budget it gets a SIGTERM,
    which prints its line and stops its section."""
    from yolo_continuous_tpu_torch import bench
    env = dict(os.environ, **BENCH_ENV)
    proc = subprocess.Popen([sys.executable, "-m", "yolo_continuous_tpu_torch.bench", str(BS)],
                            cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        out, err = proc.communicate(timeout=int(BENCH_ENV["BENCH_TOTAL_BUDGET"]) + 60)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    root = os.path.join(HERE, "runs", "chip_smoke_bench")
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "bench.stderr"), "w") as f:
        f.write(err)
    for line in err.splitlines():
        if line.startswith("[bench "):
            print(f"  {line}", flush=True)
    lines = out.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"bench: exit code {proc.returncode}, stderr {err[-1500:]}")
    try:
        result = json.loads(lines[-1])
    except json.JSONDecodeError:
        fail(f"bench: the last line is not JSON: {lines[-1][:300]}")
    passes = [json.loads(line[len(bench.PASSES):]) for line in err.splitlines()
              if line.startswith(bench.PASSES)]
    return result, passes


def check_bench_result(result) -> None:
    """The bench's line: no ``error``, the card as its device, every key > 0."""
    if "error" in result:
        fail(f"bench: error {result['error']}")
    if result.get("device", {}).get("backend") != "cuda":
        fail(f"bench: ran on {result.get('device')}, not the card")
    sweep = result.get("train_sweep") or {}
    got = {k: result.get(k) for k in BENCH_KEYS}
    got.update({f"train_sweep[{k!r}]": sweep.get(k) for k in (str(BS), f"{BS}/bn_remat")})
    bad = {k: v for k, v in got.items() if not (isinstance(v, (int, float)) and v > 0)}
    if bad:
        fail(f"bench: keys missing or not > 0: {bad}")


def bench_calls(total) -> tuple:
    """One call of each function the bench times, on its inputs (bs 16 and 1
    @640, the first NMS draw), each with the counters at 0 just before and
    read just after: K3 once and K1 once a request, K1 once in
    ``nms_single``, K5 24 times in the fused-tail request. On the same
    calls, each kernel against its plain version: K3 on the bf16 head's
    maps (cast to fp32, in the TMA form) at bs 16 and 1, K1 on
    ``nms_single``'s candidates, K5 at the 24 shapes of the fused-tail
    request at batch 1 on O(1) inputs (timed beside its plain version and
    its bound)."""
    import torch
    from yolo_continuous_tpu_torch import bench
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.kernels.decode import decode_outputs_cuda, form_for
    from yolo_continuous_tpu_torch.kernels.fused_conv import (fused_pointwise_conv_cuda,
                                                              fused_pointwise_conv_plain)
    from yolo_continuous_tpu_torch.kernels.nms import nms_suppress
    from yolo_continuous_tpu_torch.ops.decode import decode_level
    from yolo_continuous_tpu_torch.ops.nms import suppress_plain, top_candidates

    plan = bench.infer_plan(SIZE)
    variants, singles, preds = bench.infer_inputs(BS, SIZE)
    x16, x1, p = (torch.from_numpy(a[0]).cuda() for a in (variants, singles, preds))
    del variants, singles, preds
    det = Detector(plan, device="cuda", head_dtype=torch.bfloat16)
    det_f = Detector(plan, device="cuda", head_dtype=torch.bfloat16, fused_tails=True)
    det_q = Detector(plan, device="cuda", head_dtype=torch.bfloat16, quantize=True)
    det_q.calibrate(x16)
    calls = {"infer_img_s": (bench.infer_step(det), x16, BS),
             "infer_1_ms": (bench.infer_step(det), x1, 1),
             "nms_p50_ms": (bench.nms_step, p, None),
             "infer_1_ms_fused_tails": (bench.infer_step(det_f), x1, 1),
             "infer_img_s_int8": (bench.infer_step(det_q), x16, BS)}
    want = {key: {"decode_outputs_cuda": int(bs is not None), "nms_suppress": 1,
                  "fused_pointwise_conv_cuda": 24 if key == "infer_1_ms_fused_tails" else 0,
                  "nms_suppress_tiled": 0, "decode_outputs_bin_cuda": 0, "stage_letterbox": 0}
            for key, (_, _, bs) in calls.items()}
    zero = torch.zeros((), device="cuda")
    per_call = {}
    for key, (fn, x, bs) in calls.items():
        torch.cuda.synchronize()
        for c in counters():
            c.launches = 0
        out = fn(x, zero)
        torch.cuda.synchronize()
        per_call[key] = {c.__name__: c.launches for c in counters()}
        if bs is None:
            if out[0].shape != (300, 4) or not torch.isfinite(out[0]).all() or not out[3].any():
                fail(f"bench {key}: nms_single gave {tuple(out[0].shape)}, none kept or not finite")
        else:
            check_request(f"bench {key}", out, det.spec.nc, bs)
        if per_call[key] != want[key]:
            fail(f"bench {key}: launches {per_call[key]}, expected {want[key]}")
    for name, n in ((c.__name__, sum(pc[c.__name__] for pc in per_call.values()))
                    for c in counters()):
        total[name] += n

    checks = {}
    spec = det.spec
    with torch.inference_mode():
        for bs, x in ((BS, x16), (1, x1)):
            maps = [m.float() for m in det.forward(x)]
            if form_for(maps) != "tma":
                fail(f"bench: K3 at bs {bs} takes the {form_for(maps)} form, not tma")
            got = decode_outputs_cuda(maps, spec.anchors, spec.strides, True)
            plain = torch.cat([decode_level(m, torch.tensor(a), float(s), True)
                               for m, a, s in zip(maps, spec.anchors, spec.strides)], 1)
            err = (got - plain).abs().max().item()
            if err > DECODE_TOL:
                fail(f"bench: K3 at bs {bs} on the bf16 head's maps: max abs err {err}")
            checks[f"k3_bs{bs}_max_abs_err"] = err
        boxes, _, classes, valid = top_candidates(p[None], CONF, 300)
        keep = nms_suppress(boxes, classes, valid, IOU)
        if not torch.equal(keep, suppress_plain(boxes, classes, valid, IOU)):
            fail("bench: K1 on nms_single's candidates differs from the plain version")
        checks["k1_nms_single_keep_equal"] = True
    del det, det_f, det_q
    torch.cuda.empty_cache()

    # K5 at the 24 shapes of the fused-tail request at batch 1, on O(1)
    # inputs as phase 2 draws them: the request's own activations are too
    # small under random weights for an absolute tolerance to test anything
    shapes = fused_tail_shapes(1)
    g = torch.Generator(device="cuda").manual_seed(1)
    k5 = dict.fromkeys(("ms", "plain_ms", "bound_ms", "max_abs_err"), 0.0)
    for c, n, h, w in shapes:
        args = k5_inputs(g, 1, c, n, h, w, torch.bfloat16)
        with torch.inference_mode():
            k5["max_abs_err"] = max(k5["max_abs_err"], k5_compare(args, K5_TOL["bf16"]))
            if not torch.equal(fused_pointwise_conv_cuda(*args),
                               fused_pointwise_conv_cuda(*args)):
                fail(f"bench: K5 at {tuple(args[0].shape)}: two calls on one input differ")
            k5["ms"] += cuda_ms(lambda: fused_pointwise_conv_cuda(*args))
            k5["plain_ms"] += cuda_ms(lambda: fused_pointwise_conv_plain(*args), iters=5)
        nbytes = (c * h * w + n * c + n * h * w) * 2 + 2 * n * 4
        k5["bound_ms"] += max(nbytes / HBM_BYTES_S, 2.0 * n * c * h * w / BF16_FLOP_S) * 1e3
    checks["k5_bs1"] = dict(calls=len(shapes), form="wgmma", **k5)
    print(f"bench: K5 at batch 1 at the fused-tail request's 24 shapes: {k5['ms']:.4f} ms "
          f"(bound {k5['bound_ms']:.4f}, plain {k5['plain_ms']:.4f}), max abs err "
          f"{k5['max_abs_err']:.3g}", flush=True)
    return per_call, checks


def phase_bench(beside=None):
    """The port's bench on the card, then its timed functions counted and
    their kernels held against their plain versions in this process."""
    import torch
    t_phase = time.perf_counter()
    result, passes = run_bench()
    check_bench_result(result)
    total = {fn.__name__: 0 for fn in counters()}
    per_call, checks = bench_calls(total)
    beside = beside or {}
    rec = dict(result=result, passes=passes, env=BENCH_ENV, launches_per_call=per_call,
               kernels_at_bench_shapes=checks,
               # phase 4's default path (fp32 head) and phase 5's step, not gated
               beside=dict(bench_infer_img_s=result["infer_img_s"],
                           phase4_default_img_s=beside.get("infer_img_s", "phase 4 not run"),
                           bench_value=result["value"],
                           phase5_train_img_s=beside.get("train_img_s", "phase 5 not run")),
               phase_s=time.perf_counter() - t_phase)
    print(json.dumps({"bench": rec}), flush=True)
    del rec
    torch.cuda.empty_cache()
    return total, checks["k5_bs1"]


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch port")
    ap.add_argument("--only", choices=["serve", "parallel_and_tools", "native_staging", "bench"],
                    help="build the kernels and run this phase alone (a debugging aid: "
                         "it prints no result line)")
    ap.add_argument("--serve-clients", nargs=2, metavar=("PORT", "JPEGS"),
                    help=argparse.SUPPRESS)      # phase 8's client process
    args = ap.parse_args()
    if args.serve_clients:
        serve_clients(int(args.serve_clients[0]), args.serve_clients[1])
        return
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
    if args.only:
        {"serve": phase_serve, "parallel_and_tools": phase_parallel_and_tools,
         "native_staging": phase_native_staging, "bench": phase_bench}[args.only]()
        print(f"chip_smoke: --only {args.only} passed (no result line)", flush=True)
        return

    plan = random_weights_plan()
    spec = build_model_spec(cvt_cfg(plan.model_cfg), plan.image_chan, plan.anchors,
                            plan.num_labels, plan.anchors_mask)
    bin_spec = build_model_spec(ibin_net(), plan.image_chan, plan.anchors, plan.num_labels,
                                plan.anchors_mask)
    k5_shapes = fused_tail_shapes()
    report = phase_kernels(spec, bin_spec, k5_shapes)
    phase_reference()
    launches, main_img_s = phase_main()
    train_img_s = phase_train()
    phase_train_reference()
    launches_validate_map = phase_train_run()
    launches_model_zoo, k3_p6 = phase_model_zoo()
    launches_serve = phase_serve()
    launches_parallel = phase_parallel_and_tools()
    launches_native, stager = phase_native_staging()
    launches_bench, k5_bs1 = phase_bench(dict(infer_img_s=main_img_s, train_img_s=train_img_s))

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
        if name == "decode_level":  # K3 at the P6 shape: 4 levels, 16 x 102,000 x 85
            other.update({f"{k}_p6": k3_p6[k] for k in ("ms", "strided_ms", "bound_ms",
                                                         "max_abs_err")})
        if name == "fused_conv":    # K5 at batch 1: the bench's fused-tail request, 24 calls
            other.update({f"{k}_bs1": k5_bs1[k] for k in ("ms", "plain_ms", "bound_ms",
                                                           "max_abs_err")})
        kernels.append(dict(name=name, route="cuda", source=f"yolo_continuous_tpu_torch/{src}",
                            replaces=replaces, launches=launches[counter],
                            launches_validate_map=launches_validate_map[counter],
                            launches_model_zoo=launches_model_zoo[counter],
                            launches_serve=launches_serve[counter],
                            launches_parallel=launches_parallel[counter],
                            launches_native_staging=launches_native[counter],
                            launches_bench=launches_bench[counter],
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"], **other))
    # the stager replaces a host library, not a TPU kernel; its main path is
    # phase 10's Trainer.run without the pool
    counter = "stage_letterbox"
    kernels.append(dict(name="stage_letterbox", route="cuda",
                        source="yolo_continuous_tpu_torch/csrc/staging.cu",
                        replaces="native/staging.cpp:70 through "
                                 "yolo_continuous_tpu/data/native_loader.py:62",
                        launches=launches_native[counter],
                        launches_main_paths=launches[counter],
                        launches_validate_map=launches_validate_map[counter],
                        launches_model_zoo=launches_model_zoo[counter],
                        launches_serve=launches_serve[counter],
                        launches_parallel=launches_parallel[counter],
                        launches_native_staging=launches_native[counter],
                        launches_bench=launches_bench[counter], **stager))
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
