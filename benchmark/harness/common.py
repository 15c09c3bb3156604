"""What every cell shares: finding a cell's files by name, seeds, weights and
images made from the seed, the host clock and CUDA-event records, the
profiler's reduction, the per-layer readers and the result line."""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_continuous_tpu")
TRACE_SECONDS = 2.0      # the traced part of a --trace 1 window: its last seconds


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """A workload of BENCHMARK.json with its configuration, traffic mix and
    limits, each found by name under ``benchmark/``."""
    bench = bench or benchmark_json()
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return {"workload": wl, "config": load_json(ROOT / cfg_entry["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{wl['traffic']}.json"),
            "limits": load_json(BENCH / "limits" / f"{name}.json")}


def seed_words(seed: int, *extra: int) -> List[int]:
    """A seed of any size as 32-bit words for ``np.random.RandomState``."""
    seed = int(seed)
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, (seed >> 64) & 0xFFFFFFFF]
    return words + [int(e) & 0xFFFFFFFF for e in extra]


def rng(seed: int, *extra: int) -> np.random.RandomState:
    return np.random.RandomState(seed_words(seed, *extra))


# ---------------------------------------------------------------- weights

def make_weights(shapes: Sequence[Tuple[str, tuple, object]], seed: int, device) -> dict:
    """A state dict drawn on ``device`` from ``seed`` in a few large calls,
    at a scale that keeps activations O(1) through the depth: convolution
    weights of fan-in n ~ N(0, 1/n), biases and running means ~ 0.1 N(0, 1),
    running variances ~ U(0.5, 1.5), BatchNorm scales 1."""
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    conv = [(k, s) for k, s, d in shapes if k.endswith("weight") and len(s) == 4]
    small = [(k, s) for k, s, d in shapes if k.endswith(("bias", "running_mean"))]
    var = [(k, s) for k, s, d in shapes if k.endswith("running_var")]
    out = {}

    def fill(group, draw, scale=None):
        sizes = [int(np.prod(s)) for _, s in group]
        flat = draw(sum(sizes))
        if scale is not None:
            flat = flat * torch.repeat_interleave(
                torch.tensor([scale(s) for _, s in group], device=device),
                torch.tensor(sizes, device=device))
        for (k, s), part in zip(group, torch.split(flat, sizes)):
            out[k] = part.view(s)

    fill(conv, lambda n: torch.randn(n, generator=gen, device=device),
         lambda s: float(np.prod(s[1:])) ** -0.5)
    fill(small, lambda n: 0.1 * torch.randn(n, generator=gen, device=device))
    fill(var, lambda n: 0.5 + torch.rand(n, generator=gen, device=device))
    for k, s, d in shapes:
        if k not in out:
            out[k] = (torch.zeros(s, dtype=d, device=device) if k.endswith("num_batches_tracked")
                      else torch.ones(s, device=device))
    return out


# ---------------------------------------------------------------- images

def photo_like(rs: np.random.RandomState, w: int, h: int, classes: int = 80):
    """A smooth background with 1-8 flat boxes in the colours of their classes;
    returns the RGB image and its boxes (k, 5) [x1, y1, x2, y2, cls]."""
    base = rs.randint(40, 200, 3).astype(np.float32)
    fx, fy = rs.uniform(20, 80), rs.uniform(20, 80)
    img = (base + 40 * np.sin(np.arange(w, dtype=np.float32) / fx)[None, :, None]
           + 30 * np.cos(np.arange(h, dtype=np.float32) / fy)[:, None, None])
    img = np.clip(img, 0, 255).astype(np.uint8)
    boxes = []
    for _ in range(rs.randint(1, 9)):
        bw, bh = rs.randint(w // 12, w // 3), rs.randint(h // 12, h // 3)
        x, y = rs.randint(0, w - bw), rs.randint(0, h - bh)
        c = rs.randint(classes)
        img[y:y + bh, x:x + bw] = ((c * 37) % 256, (c * 91) % 256, (c * 53) % 256)
        boxes.append((x, y, x + bw, y + bh, c))
    return img, np.array(boxes, np.float32).reshape(-1, 5)


def jpegs(n: int, seed: int, w: int, h: int, salt: int, threads: int = 8):
    """``n`` photo-like JPEGs (bytes) of ``w`` x ``h`` with their boxes, made
    in parallel, image i from ``(seed, salt, i)``."""
    import cv2

    def one(i):
        img, boxes = photo_like(rng(seed, salt, i), w, h)
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                               [cv2.IMWRITE_JPEG_QUALITY, 90])
        assert ok
        return buf.tobytes(), boxes

    with ThreadPoolExecutor(threads) as ex:
        out = list(ex.map(one, range(n)))
    return [o[0] for o in out], [o[1] for o in out]


def write_dataset(root: str, datas: Sequence[bytes], boxes: Sequence[np.ndarray]) -> str:
    """The JPEGs as files under ``root`` and their annotation file
    (``path x1,y1,x2,y2,cls ...``); returns its path."""
    lines = []
    for i, (data, bx) in enumerate(zip(datas, boxes)):
        path = os.path.join(root, f"im{i:05d}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        lines.append(" ".join([path] + [",".join(str(int(v)) for v in b) for b in bx]) + "\n")
    ann = os.path.join(root, "train.txt")
    with open(ann, "w") as f:
        f.writelines(lines)
    return ann


def body_dtype(device):
    """The precision in which the configurations state that a request's body
    runs: the port's on the card (bf16); fp32 on the CPU, where the port
    runs fp32 (the tests)."""
    import torch
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


# ---------------------------------------------------------------- plans

PLAN = dict(
    device="cuda", image_chan=3, epochs=300, batch_size=16, enhance=True, shuffle=True,
    pin_memory=True, drop_last=True, workers=4, adam=False, decay="Cosine", lrI=0.001,
    lrF=0.1, momentum=0.937, weight_decay=0.0005, warmup=False, warmup_epochs=3,
    warmup_max_iter=1000, warmup_momentum=0.8, warmup_bias_lr=0.1, focal_gamma=1.5,
    focal_alpha=0.25, iou_loss_ratio=1.0, anchor_t=4.0, resume=False, save_name="bench")


def plan_dict(cfg: dict, ann: str, save_dir: str, seed: int, **keys) -> dict:
    """A train plan for the port from a configuration: the repo's
    ``cfg/coco_train.yaml`` keys (``PLAN``), the net's rows, anchors and
    classes from ``cfg``, then ``keys``."""
    d = dict(PLAN)
    d.update(train=ann, val=ann, image_size=cfg["image_size"],
             labels=[f"c{i}" for i in range(cfg["num_classes"])],
             model_cfg={k: cfg[k] for k in ("depth_multiple", "width_multiple", "backbone",
                                            "head")},
             anchors=cfg["anchors"], anchors_mask=cfg["anchors_mask"], save_dir=save_dir,
             seed=int(seed) & 0x7FFFFFFF, enhance_cfg={})
    d.update(keys)
    return d


# ---------------------------------------------------------------- records

class Records:
    """Host-clock spans (seconds) and CUDA-event pairs (ms, read after the
    window) by name; ``span`` also marks the profiler's trace."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans: Dict[str, List[float]] = {}
        self._pairs: Dict[str, list] = {}

    def span(self, name: str):
        rec = self

        class _Span:
            def __enter__(self):
                import torch
                self.rf = torch.profiler.record_function(f"bench/{name}")
                self.rf.__enter__()
                self.t = time.perf_counter()

            def __exit__(self, *exc):
                rec.spans.setdefault(name, []).append(time.perf_counter() - self.t)
                self.rf.__exit__(*exc)
        return _Span()

    def mark(self):
        """A CUDA event recorded now on the current stream (None off CUDA)."""
        if not self.cuda:
            return None
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def pair(self, name: str, a, b) -> None:
        if a is not None:
            self._pairs.setdefault(name, []).append((a, b))

    def events(self) -> Dict[str, List[float]]:
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self._pairs.items()}


class Tracer:
    """The profiler over the last ``TRACE_SECONDS`` of a window
    (``maybe_start`` from the window's loop), reduced by ``summary``."""

    def __init__(self, on: bool, seconds: float, cuda: bool):
        self.on, self.cuda = on, cuda
        self.start_at = max(seconds - TRACE_SECONDS, 0.0)
        self.prof, self.t0, self.t1 = None, None, None
        if on:
            # the profiler's first start (CUPTI's set-up) takes seconds: pay it
            # here, in set-up, and not inside the window
            import torch
            with torch.profiler.profile(activities=self._activities()):
                torch.ones(1, device="cuda" if cuda else "cpu").add_(1)
                if cuda:
                    torch.cuda.synchronize()

    def _activities(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def maybe_start(self, elapsed: float) -> None:
        if not self.on or self.prof is not None or elapsed < self.start_at:
            return
        import torch
        if self.cuda:
            # work enqueued before the trace would run untraced inside it and
            # read as idle: the trace starts on an empty queue
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is not None and self.t1 is None:
            if self.cuda:
                import torch
                torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.prof.__exit__(None, None, None)

    def summary(self) -> Optional[dict]:
        if self.prof is None:
            return None
        return reduce_trace(self.prof, self.t1 - self.t0)


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{which}_us")() * 1000)


def reduce_trace(prof, window_s: float) -> dict:
    """Device time by kernel name, the union of device activity (busy_s),
    the ten longest device operations by name and the ten longest idle
    gaps, each named by what the host was doing when it began."""
    import torch
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + int(e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1e3)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.name().startswith("bench/"):    # the spans' marks on the device's line
                dev.append((start, end, e.name()))
        else:
            host.append((start, end, e.name()))
    kernels: Dict[str, list] = {}
    for s, t, n in dev:
        k = kernels.setdefault(n, [0.0, 0])
        k[0] += (t - s) / 1e9
        k[1] += 1
    dev.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, t, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e))
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    host.sort()
    gaps.sort(reverse=True)
    idle = []
    for g, at in gaps[:10]:
        covering = [h for h in host if h[0] <= at <= h[1]]
        span = [h[2] for h in covering if h[2].startswith("bench/")]
        inner = covering[-1][2] if covering else "host idle"
        name = " > ".join(([span[-1]] if span else []) + [inner])
        idle.append([name[:160], g / 1e9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"window_s": window_s, "busy_s": busy / 1e9,
            "kernels": {n: v for n, v in kernels.items()},
            "device_ops": [[n[:160], v[0]] for n, v in top], "idle_gaps": idle}


# ---------------------------------------------------------------- metrics

def reader(name: str):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def peaks(kind: str) -> dict:
    table = load_json(BENCH / "harness" / "peaks.json")
    return table.get(kind, table["default"])


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
