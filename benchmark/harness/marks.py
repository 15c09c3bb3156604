"""The port's phase marks in a traced window: each mark is an empty kernel
``mark_<name>_kernel`` that the port launches inside its captured graphs at
the start of a phase (``yolo_continuous_tpu_torch/utils/trace.py``); a phase
runs from its mark's start to the next mark's start. Read here from the
profiler's device events, as the port's ``trace.phases`` reads them, with
nothing of the port imported."""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

KERNEL = re.compile(r"(^|[^A-Za-z0-9_])mark_([a-z_]+)_kernel")
# each scope's marks in order; a sequence ends at <scope>_end
ORDER = {"step": ("step_forward", "step_loss", "step_aux", "step_backward", "step_sync",
                  "step_optimizer", "step_ema", "step_end"),
         "aug": ("aug_input", "aug_single", "aug_mosaic", "aug_enhance", "aug_mix", "aug_end")}
OPTIONAL = frozenset({"step_aux", "step_sync"})   # an auxiliary net's step; a mesh's step


def device_marks(prof) -> List[Tuple[str, int]]:
    """``[name, start_ns]`` of every mark kernel on the card in a finished
    ``torch.profiler.profile``, in time order."""
    import torch
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        m = KERNEL.search(e.name())
        if m:
            out.append([m.group(2), int(e.start_ns())])
    return sorted(out, key=lambda nt: nt[1])


def phases(marks: Sequence[Sequence], scope: str) -> Dict[str, float]:
    """Each phase of ``scope`` -> its mean ms over the complete sequences of
    ``marks``: from the scope's first mark through ``<scope>_end`` with
    every mark in order, an optional one present or not. A sequence cut by
    either edge of the trace, or out of order, is left out."""
    order = ORDER[scope]
    sums: Dict[str, List[float]] = {}
    run: List[Tuple[str, int]] = []
    for name, t in marks:
        if name not in order:
            continue
        if name == order[0]:
            run = [(name, t)]
            continue
        if not run:
            continue
        at = order.index(run[-1][0]) + 1
        while order[at] in OPTIONAL and order[at] != name:
            at += 1
        if order[at] != name:
            run = []
            continue
        run.append((name, t))
        if name == order[-1]:
            for (a, ta), (_, tb) in zip(run, run[1:]):
                sums.setdefault(a, []).append((tb - ta) / 1e6)
            run = []
    return {n: sum(sums[n]) / len(sums[n]) for n in order if n in sums}
