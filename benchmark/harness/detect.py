"""The batch-detection driver: a traffic mix of kind ``detect``.

Set-up draws the weights and ``batches`` distinct letterboxed batches of
photo-like images on the device from the seed, builds a ``Detector`` and
makes its first call (the capture). The window calls ``Detector.__call__``
on the batches in turn, each call enqueued behind the one before, until
``--seconds`` have passed and the card is done. Every call's detections
are kept; after the window the program is freed and the plain reference
judges each distinct answer.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from . import common as C
from .counts import head_rows, iou_pairs, k1_bytes, k3_bytes

IMAGE_SALT = 0x646574


@torch.no_grad()
def device_images(seed: int, n: int, w: int, h: int, size: int, device) -> torch.Tensor:
    """``n`` photo-like images of ``w`` x ``h`` (a smooth background and 1-8
    flat boxes in their classes' colours) letterboxed onto ``size`` with a
    border of 114: (n, size, size, 3) float 0..1, drawn on ``device``."""
    g = torch.Generator(device=device).manual_seed((int(seed) ^ IMAGE_SALT) & (2 ** 63 - 1))
    u = (lambda *s: torch.rand(*s, generator=g, device=device))
    base = 40 + torch.floor(160 * u(n, 1, 1, 3))
    fx, fy = 20 + 60 * u(n, 1, 1, 1), 20 + 60 * u(n, 1, 1, 1)
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, :, None]
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None, None]
    img = (base + 40 * torch.sin(xs / fx) + 30 * torch.cos(ys / fy)).clamp(0, 255).floor()
    count = 1 + torch.floor(8 * u(n))
    for k in range(8):
        bw, bh = w / 12 + (w / 3 - w / 12) * u(n), h / 12 + (h / 3 - h / 12) * u(n)
        x0, y0 = (w - bw) * u(n), (h - bh) * u(n)
        c = torch.floor(80 * u(n))
        color = torch.stack([(c * 37) % 256, (c * 91) % 256, (c * 53) % 256], -1)
        inside = ((xs >= x0[:, None, None, None]) & (xs < (x0 + bw)[:, None, None, None])
                  & (ys >= y0[:, None, None, None]) & (ys < (y0 + bh)[:, None, None, None])
                  & (k < count)[:, None, None, None])
        img = torch.where(inside, color[:, None, None, :], img)
    r = min(size / w, size / h)
    nw, nh = round(w * r), round(h * r)
    if (nw, nh) != (w, h):
        img = torch.nn.functional.interpolate(img.permute(0, 3, 1, 2), (nh, nw),
                                              mode="bilinear").permute(0, 2, 3, 1).round()
    out = torch.full((n, size, size, 3), 114.0, device=device)
    top, left = (size - nh) // 2, (size - nw) // 2
    out[:, top:top + nh, left:left + nw] = img
    return out / 255.0


def run(c: dict, seed: int, seconds: float, trace: bool, device, tmp: str, t_start: float,
        faults=None) -> dict:
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.detect_api import Detector
    from reference.model import state_shapes
    cfg, mix = c["config"], c["traffic"]
    d = mix["detect"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    size, B = cfg["image_size"], d["batch"]
    weights = C.make_weights(state_shapes(cfg), seed, dev)
    plan = TrainPlan(C.plan_dict(cfg, "", tmp, seed))
    det = Detector(plan, device=dev, state_dict=weights)
    inputs = device_images(seed, d["batches"] * B, d["width"], d["height"], size, dev)
    inputs = inputs.view(d["batches"], B, size, size, 3)
    if faults and "detector" in faults:
        det = faults["detector"](det, weights, inputs[0])
    key = (d["conf"], d["iou"], d["max_det"])
    t_built = time.perf_counter()
    det(inputs[0], *key)
    if cuda:
        torch.cuda.synchronize()
    t_first = time.perf_counter()
    tracer = C.Tracer(trace, seconds, cuda)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    print(f"[setup] {setup_s:.2f} s: to the program and inputs {t_built - t_start:.2f}, the "
          f"first call {t_first - t_built:.2f}, the profiler {t0 - t_first:.2f}", file=sys.stderr)
    outs = []
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
        tracer.maybe_start(elapsed)
        i = len(outs) % d["batches"]
        outs.append((i, det(inputs[i], *key)))
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    traced = tracer.summary()
    del det
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, pairs = compare(cfg, d, weights, inputs, outs, dev)
    rows = head_rows(size)
    ctx = {"window_s": window_s, "items": len(outs) * B, "trace": traced,
           "counts": {"forward_flops": _flops(cfg), "k3_bytes": k3_bytes(B, rows, 85),
                      "k1_bytes": k1_bytes(B, d["max_det"]), "k1_pair_tests": pairs}}
    return {"setup_s": setup_s, "ctx": ctx, "checks": checks, "peak": peak,
            "attempted": len(outs) * B, "failed": 0,
            "e2e": {"detect_img_s": len(outs) * B / window_s}}


def _flops(cfg):
    from .counts import forward_flops
    return forward_flops(cfg)


@torch.no_grad()
def reference_rows(cfg, weights, images, dev, block: int = 8, body_dtype=torch.float32):
    """The plain reference's decoded rows of a batch, in blocks of images,
    its body in ``body_dtype``."""
    from reference.model import PlainYolo
    from reference.postprocess import decode
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = PlainYolo(cfg).to(dev)
    model.load_state_dict(weights, strict=True)
    model.eval()
    out = []
    for s in range(0, images.shape[0], block):
        x = images[s:s + block].permute(0, 3, 1, 2).contiguous()
        out.append(decode(model(x, body_dtype), model.anchors, model.strides))
    return torch.cat(out)


def compare(cfg, d, weights, inputs, outs, dev):
    """Every distinct answer of the window against the reference's kept
    detections; the mean number of IoU tests K1 needs on these inputs a
    call."""
    from reference.compare import detection_gaps
    from reference.postprocess import candidates, nms
    gaps = {}
    pairs = []
    for b in range(d["batches"]):
        rows = reference_rows(cfg, weights, inputs[b], dev, d["batch"], C.body_dtype(dev))
        _, rs, rc = candidates(rows)
        kept = nms(rows, d["conf"], d["iou"], d["max_det"])
        top = torch.topk(torch.where(rs >= d["conf"], rs, torch.full_like(rs, -1.0)),
                         min(d["max_det"], rs.shape[1]), dim=1)
        cls_top = torch.gather(rc, 1, top.indices)
        pairs.append(iou_pairs([c[s > 0].tolist() for c, s in zip(cls_top, top.values)]))
        seen = []
        for i, out in outs:
            if i != b or any(all(torch.equal(x, y) for x, y in zip(out, o)) for o in seen):
                continue
            seen.append(out)
            boxes, scores, classes, valid = out
            prog = [(bx[v].float(), s[v].float(), c[v].long())
                    for bx, s, c, v in zip(boxes, scores, classes, valid)]
            g = detection_gaps(prog, kept)
            gaps = {k: max(gaps.get(k, 0.0), v) for k, v in g.items()}
            print(f"[detect] batch {b} answer {len(seen)}: {g}", file=sys.stderr)
        print(f"[detect] batch {b}: {sum(i == b for i, _ in outs)} calls, {len(seen)} distinct "
              f"answers, {sum(len(k[1]) for k in kept)} detections kept by the reference",
              file=sys.stderr)
        del rows, rs, rc, kept
    return gaps, sum(pairs) / len(pairs)
