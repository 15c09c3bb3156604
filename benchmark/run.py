"""The benchmark of the PyTorch port (``yolo_continuous_tpu_torch``) on the GPU.

Usage, from the root of a checkout:
    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The workload is an entry of BENCHMARK.json; its configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``, whose
``kind`` names the driver ``harness/<kind>.py``), limits
(``limits/<workload>.json``) and per-layer readers (``metrics/<name>.py``)
are found by name. The run prints, as the last line of its standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; ``checks`` last, each number that
decides ``correct`` beside its limit, as they are also the last lines of
its standard error. It exits 3 without a result when no CUDA device (or
fewer than the cell asks for) is there, and 4 when a module of JAX or of the
JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths: the
    port builds its kernels under ``yolo_continuous_tpu_torch/_build``; these
    hold what torch's extension loader or Triton would build."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".bench_cache", "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".bench_cache", "triton"))


def execute(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            bench: dict = None, cell: dict = None, faults=None, t_start: float = None,
            numbers: dict = None) -> dict:
    """One run of a workload; returns the result object (without printing).
    ``cell`` and ``faults`` let the tests run a cut-down cell on the CPU and
    break the timed path underneath; ``numbers``, a dict, receives every
    number the comparison computed, those without a limit too."""
    from harness import common as C
    bench = bench or C.benchmark_json()
    cell = cell or C.cell(name, bench)
    driver = importlib.import_module(f"harness.{cell['traffic']['kind']}")
    tmp = tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))
    try:
        out = driver.run(cell, seed, seconds, trace, device, tmp,
                         T_START if t_start is None else t_start, faults)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    limits, computed = cell["limits"], out["checks"]
    if numbers is not None:
        numbers.update(computed)
    checks = {k: {"value": float(computed.get(k, float("inf"))), "limit": float(v)}
              for k, v in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    others = {k: v for k, v in computed.items() if k not in limits}
    if others:
        print(f"[numbers not compared] {json.dumps(others)}", file=sys.stderr)
    metrics = {}
    for m in C.metrics_for(bench, name, trace):
        if not trace:
            v = out["setup_s"] if m["name"] == "setup_s" else out["e2e"].get(m["name"])
        else:
            ctx = dict(out["ctx"], workload=name, kind=cell["traffic"]["kind"],
                       peaks=C.peaks(device_kind(device)), config=cell["config"])
            v = C.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": device_kind(device),
           "count": 1, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    traced = out["ctx"].get("trace") if trace else None
    if traced:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = checks
    return result


def device_kind(device: str) -> str:
    import torch
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    caches()
    from harness import common as C
    bench = C.benchmark_json()
    cell = C.cell(a.workload, bench)
    import torch
    need = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no CUDA device, or fewer than the {need} this cell needs", file=sys.stderr)
        return 3
    print(f"[bench] {a.workload} seed {a.seed} on {C.power_limit()}", file=sys.stderr)
    result = execute(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", bench, cell)
    bad = C.forbidden_loaded()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
