#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py        # from the root of a checkout, one card

It imports only ``torch``, numpy and the port package
``yolo_continuous_tpu_torch`` (nothing of JAX), and runs in phases; any
failure exits non-zero before the result line.

1. build: compiles the port's CUDA kernels (``csrc/*.cu``, one ``nvcc``
   each, in parallel) and prints the seconds and the ptxas report.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes of the main path: K3 decode on the three yolov7 @640 levels at
   batch 16; K1 NMS at K = 300 x 16 images; K2 NMS at K = 2048 and 4096. NMS
   inputs are 25200 random candidates per image cut to the top K (as the
   JAX bench builds them), plus a chained-overlap case; keep-sets must be
   identical, decode within its stated tolerance.
3. reference: the ``Detector`` on CUDA in fp32 against the same seeded
   ``Detector`` on the CPU (plain versions), yolov7 at 64 px: raw head maps
   and decoded rows within tolerance, NMS keep-set of the kernel equal to the
   plain one on the same rows.
4. main path: ``Detector`` on ``cfg/coco_train.yaml`` (yolov7, 80 classes,
   640 px), seeded random weights, bf16 body, batch 16, conf 0.25, IoU 0.45:
   a few requests at max_det 300 and one at max_det 4096 (which takes K2).
   Launch counters are set to 0 just before and read just after; every
   kernel must have launched. Stage times come from CUDA events, the
   host's enqueue time of one request from its clock, and the device's busy
   share and kernel launches per request from a short profiler window.

Before the last line it prints the ``kernels`` JSON line (time, bound,
launches, error of each kernel) and the card's name and power limit; the
last line is ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor flop/s
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
IOU_OPS = 13        # fp32 operations of one IoU test (4 min/max, 4 sub, 2 clamp, mul, add, div)
DECODE_TOL = 1e-5   # K3 vs plain, normalized rows: expf vs torch.exp differ by ulps
BS, SIZE, CONF, IOU = 16, 640, 0.25, 0.45


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def phase_kernels(spec):
    """Each kernel against its plain version at main-path shapes."""
    import torch
    from yolo_continuous_tpu_torch.kernels.decode import decode_outputs_cuda
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

    report = {}
    got = decode_outputs_cuda(maps, spec.anchors, spec.strides, True)
    want = plain_decode(True)
    err = (got - want).abs().max().item()
    if not (got.shape == want.shape and err <= DECODE_TOL):
        fail(f"K3 decode: max abs err {err} > {DECODE_TOL} (shape {tuple(got.shape)})")
    px_got = decode_outputs_cuda(maps, spec.anchors, spec.strides, False)
    if not torch.allclose(px_got, plain_decode(False), rtol=1e-5, atol=1e-4):
        fail("K3 decode (pixel mode) disagrees with the plain version")
    rows = got.shape[1]
    report["decode_level"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: decode_outputs_cuda(maps, spec.anchors, spec.strides, True)),
        plain_ms=cuda_ms(plain_decode),
        bound_ms=2 * BS * rows * no * 4 / HBM_BYTES_S * 1e3, bound_by="bytes")
    print(f"K3 decode: {BS}x{rows}x{no} max_abs_err {err:.3g} (tol {DECODE_TOL})", flush=True)

    rs = np.random.RandomState(0)
    cases = {"nms_suppress": [(300, nms_inputs(rs, 300, BS)), (300, dense_inputs(rs, 300, BS)),
                              (1024, dense_inputs(rs, 1024, 4)), (300, chain_inputs(300))],
             "nms_suppress_tiled": [(4096, nms_inputs(rs, 4096, BS)),
                                    (2048, nms_inputs(rs, 2048, BS)),
                                    (4096, dense_inputs(rs, 4096, 4)),
                                    (2048, chain_inputs(2048))]}
    for name, fn in (("nms_suppress", nms_suppress), ("nms_suppress_tiled", nms_suppress_tiled)):
        err = 0.0
        for k, args in cases[name]:
            got = fn(*args, IOU)
            want = suppress_plain(*args, IOU)
            err = max(err, (got.float() - want.float()).abs().max().item())
            if not torch.equal(got, want):
                fail(f"{name} K={k}: keep-set differs from the plain version in "
                     f"{int((got != want).sum())} places")
            chain = args[0].shape[0] == 1
            if chain and not torch.equal(got[0], torch.arange(k, device="cuda") % 2 == 0):
                fail(f"{name} K={k}: greedy keeps exactly every other box of the chain")
            print(f"{name}: K={k} x {args[0].shape[0]} keep-set equal "
                  f"({int(got.sum())} kept of {int(args[2].sum())} valid)", flush=True)
        k, args = cases[name][0]
        b = args[0].shape[0]
        ops = b * k * (k - 1) / 2 * IOU_OPS          # one IoU test per pair, as greedy needs
        nbytes = b * k * (16 + 4 + 1 + 1)            # boxes, classes, valid in; keep out
        report[name] = dict(
            max_abs_err=err, ms=cuda_ms(lambda: fn(*args, IOU)),
            plain_ms=cuda_ms(lambda: suppress_plain(*args, IOU), iters=5, warmup=1),
            bound_ms=max(ops / FP32_FLOP_S, nbytes / HBM_BYTES_S) * 1e3,
            bound_by="operations" if ops / FP32_FLOP_S > nbytes / HBM_BYTES_S else "bytes")
        print(f"{name}: timed at K={k} x {b} images", flush=True)
    return report


def random_weights_plan():
    """The flagship plan, pointed at a checkpoint that does not exist, so the
    Detector takes its seeded random init."""
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    plan = TrainPlan("cfg/coco_train.yaml")
    plan.save_path = os.path.join(HERE, "runs", "chip_smoke_random_init.msgpack")
    if os.path.exists(os.path.splitext(plan.save_path)[0] + ".pth"):
        fail(f"{plan.save_path} has a .pth beside it; the smoke test uses random weights")
    return plan


def phase_reference():
    """CUDA Detector (fp32) against the same seeded CPU Detector (plain)."""
    import torch
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.ops.decode import decode_outputs
    from yolo_continuous_tpu_torch.ops.nms import suppress, suppress_plain, top_candidates

    plan = random_weights_plan()
    plan.image_size = 64
    cpu = Detector(plan, device="cpu", dtype=torch.float32, seed=1)
    # weights at a scale that keeps activations O(1) through the depth, so
    # the maps depend on the input and the scores are spread
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in cpu.model.state_dict().items():
            if name.endswith("weight") and t.dim() == 4:
                t.normal_(0.0, (1.0 / t[0].numel()) ** 0.5, generator=gen)
            elif name.endswith(("running_mean", "bias")):
                t.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)
    gpu = Detector(plan, device="cuda", dtype=torch.float32, state_dict=cpu.model.state_dict())
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype("float32")
    maps_c, maps_g = cpu.forward(x), gpu.forward(x)
    for c, g in zip(maps_c, maps_g):
        if not torch.allclose(g.cpu(), c, atol=5e-3, rtol=2e-3):
            fail(f"CUDA forward differs from the CPU forward: {(g.cpu() - c).abs().max().item()}")
    with torch.inference_mode():
        pred_c = decode_outputs(maps_c, cpu.spec.anchors, cpu.spec.strides)
        pred_g = decode_outputs(maps_g, gpu.spec.anchors, gpu.spec.strides)
        if not torch.allclose(pred_g.cpu(), pred_c, atol=1e-4, rtol=1e-4):
            fail(f"CUDA decode differs from the CPU decode: "
                 f"{(pred_g.cpu() - pred_c).abs().max().item()}")
        boxes, _, classes, valid = top_candidates(pred_g, 0.01, min(300, pred_g.shape[1]))
        if not torch.equal(suppress(boxes, classes, valid, IOU),
                           suppress_plain(boxes, classes, valid, IOU)):
            fail("NMS keep-set on the CUDA rows differs from the plain version")
    print(f"reference: yolov7 @64 fp32 CUDA == CPU (maps atol 5e-3, rows atol 1e-4); "
          f"keep-set exact, {int(valid.sum())} valid, "
          f"{int(suppress(boxes, classes, valid, IOU).sum())} kept", flush=True)


def phase_main():
    """The main path at full width, with launch counts and stage times."""
    import torch
    from yolo_continuous_tpu_torch.detect_api import Detector
    from yolo_continuous_tpu_torch.kernels.decode import decode_outputs_cuda
    from yolo_continuous_tpu_torch.kernels.nms import nms_suppress, nms_suppress_tiled
    from yolo_continuous_tpu_torch.ops.decode import decode_outputs
    from yolo_continuous_tpu_torch.ops.nms import batched_nms

    plan = random_weights_plan()
    det = Detector(plan, device="cuda", seed=0)
    rs = np.random.RandomState(0)
    images = torch.from_numpy(rs.rand(BS, SIZE, SIZE, 3).astype("float32")).cuda()
    det(images, CONF, IOU, 300)          # warm cuDNN before the counted run
    torch.cuda.synchronize()

    counters = (decode_outputs_cuda, nms_suppress, nms_suppress_tiled)
    for fn in counters:
        fn.launches = 0
    outs = [det(images, CONF, IOU, 300) for _ in range(3)] + [det(images, CONF, IOU, 4096)]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    for name, n in launches.items():
        if n == 0:
            fail(f"main path never launched {name}")
    for max_det, (boxes, scores, classes, valid) in zip((300, 300, 300, 4096), outs):
        if boxes.shape != (BS, max_det, 4) or scores.shape != (BS, max_det):
            fail(f"main path output shape {tuple(boxes.shape)}")
        if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
            fail("main path output is not finite")
        if bool((scores[valid] < CONF).any()) or bool((classes[valid] >= plan.num_labels).any()):
            fail("main path kept a detection under the threshold or of an unknown class")

    with torch.inference_mode():
        maps = det.forward(images)
        pred = decode_outputs(maps, det.spec.anchors, det.spec.strides)
        stages = dict(
            forward_ms=cuda_ms(lambda: det.forward(images), iters=10),
            decode_ms=cuda_ms(lambda: decode_outputs(maps, det.spec.anchors, det.spec.strides)),
            nms_ms=cuda_ms(lambda: batched_nms(pred, CONF, IOU, 300)),
            total_ms=cuda_ms(lambda: det(images, CONF, IOU, 300), iters=10))
    stages["img_s"] = BS / stages["total_ms"] * 1e3
    stages["kept_per_image"] = float(outs[0][3].sum()) / BS
    # host time to enqueue one request on an idle card: near total_ms, the
    # host and not the card sets the pace
    host_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det(images, CONF, IOU, 300)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    stages["host_enqueue_ms"] = float(np.median(host_ms))
    print(json.dumps({"main_path": dict(config="cfg/coco_train.yaml yolov7 640px bf16",
                                        batch=BS, conf=CONF, iou=IOU, max_det=300,
                                        **stages)}), flush=True)
    print(json.dumps({"profile": profile_window(lambda: det(images, CONF, IOU, 300))}),
          flush=True)
    return launches


def profile_window(fn, calls: int = 3) -> dict:
    """Kernel time by name and the device's busy share over a few calls
    (torch.profiler; the profiler's own cost is in the wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
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
    report = phase_kernels(spec)
    phase_reference()
    launches = phase_main()

    meta = {
        "decode_level": ("csrc/decode.cu", "yolo_continuous_tpu/kernels/decode_pallas.py:67",
                         "decode_outputs_cuda"),
        "nms_suppress": ("csrc/nms.cu", "yolo_continuous_tpu/kernels/nms_pallas.py:64",
                         "nms_suppress"),
        "nms_suppress_tiled": ("csrc/nms.cu", "yolo_continuous_tpu/kernels/nms_pallas.py:131",
                               "nms_suppress_tiled"),
    }
    kernels = []
    for name, (src, replaces, counter) in meta.items():
        r = report[name]
        kernels.append(dict(name=name, route="cuda", source=f"yolo_continuous_tpu_torch/{src}",
                            replaces=replaces, launches=launches[counter],
                            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
