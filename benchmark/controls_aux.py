"""The control and the planted faults of a training cell whose net has
auxiliary heads (kind ``train_aux``), as ``controls.py`` has them for the
other kinds.

Usage, from the root of a checkout on the card:
    python3 benchmark/controls_aux.py --workload <name> --seeds 1,2,3 [--seconds S]
        [--what sound,control,fault_name,...]

- ``control``: the plain reference with its convolutions in float8 e4m3 in
  the program's place, judged against the reference (``train_aux.control``).
- The faults, planted in the timed path: ``controls.py``'s unchanged step,
  half batch and altered augmentation, and two of the auxiliary heads':
  ``aux_dropped`` (the auxiliary loss at weight 0) and ``aux_narrowed`` (the
  auxiliary assignment's cells at g = 0.5, the lead's, in place of 1.0).
- ``sound``: the program as the benchmark runs it.

Each run prints one JSON line: the workload, what was planted, the seed,
``correct``, every number computed, and each compared one beside its limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import controls  # noqa: E402


def aux_dropped(loop):
    """The auxiliary heads' loss at weight 0: they are left untrained."""
    t = loop.t
    t.loss_cfg = dataclasses.replace(t.loss_cfg, aux_weight=0.0)


def aux_narrowed(loop):
    """The auxiliary assignment's candidate cells at the lead's gain, 0.5,
    in place of 1.0 (find_3_positive in place of find_5_positive), for the
    span of each loss the Trainer computes."""
    from yolo_continuous_tpu_torch.losses import yolo_loss as Y
    t = loop.t
    real_loss, real_cells = t.loss_from_outputs, Y._candidates_level

    def narrowed(tgt, tmask, h, w, anchors_f, threshold, g=0.5):
        return real_cells(tgt, tmask, h, w, anchors_f, threshold, min(g, 0.5))

    def loss(*a, **k):
        Y._candidates_level = narrowed
        try:
            return real_loss(*a, **k)
        finally:
            Y._candidates_level = real_cells
    t.loss_from_outputs = loss


FAULTS = {"unchanged_step": {"loop": controls.unchanged_step},
          "half_batch": {"loop": controls.half_batch},
          "augment_altered": {"loop": controls.augment_altered},
          "aux_dropped": {"loop": aux_dropped},
          "aux_narrowed": {"loop": aux_narrowed}}


def run_one(name: str, what: str, seed: int, seconds: float, device="cuda", cell=None) -> dict:
    import run
    from harness import common as C
    from harness import train_aux
    bench = C.benchmark_json()
    cell = cell or C.cell(name, bench)
    numbers = {}
    if what == "control":
        numbers = train_aux.control(cell, seed, device)
        res = controls.judged(cell, numbers)
    else:
        res = run.execute(name, seed, seconds, False, device, bench, cell,
                          faults=None if what == "sound" else FAULTS[what],
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
