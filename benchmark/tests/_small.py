"""A cell cut to a size the CPU runs in seconds: its configuration at 64 px
(yolov7-tiny's rows), its traffic at a few small images, its limits as
committed."""
from __future__ import annotations

import copy
import time

from harness import common as C


def bench() -> dict:
    return copy.deepcopy(C.benchmark_json())


def small_cell(name: str, size: int = 64, rows: str = "yolov7-tiny") -> dict:
    c = copy.deepcopy(C.cell(name, bench()))
    c["config"] = C.load_json(C.BENCH / "configs" / f"{rows}.json")
    c["config"]["image_size"] = size
    kind = c["traffic"]["kind"]
    t = c["traffic"][kind]
    t.update(width=size + size // 4, height=size - size // 16)
    if kind == "train":
        t.update(batch=2, images=8)
    else:
        t.update(batch=2, batches=2)
    return c


def run_small(name: str, seed: int = 2 ** 33 + 7, seconds: float = 2.0, trace: bool = False,
              faults=None, cell=None, numbers=None) -> dict:
    import run
    return run.execute(name, seed, seconds, trace, "cpu", bench(), cell or small_cell(name),
                       faults=faults, t_start=time.perf_counter(), numbers=numbers)
