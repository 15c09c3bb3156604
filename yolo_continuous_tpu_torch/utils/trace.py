"""Phase marks inside the captured train step and augmentation.

The step (``Trainer._update``) and the augmentation (``ops/augment``'s
``augment_batch`` and ``augment_batch_from_pool`` in train mode) each run
as one CUDA graph, so no span or event recorded around the call can see
where one of their phases ends. ``mark(name, device)`` launches an empty
kernel named ``mark_<name>_kernel`` (``csrc/marks.cu``) on the device's
current stream: inside a capture it becomes a node of the graph, so an
untraced and a traced run replay the same graph, and a profiler's device
trace shows the marks among the graph's kernels, on the same clock. A phase
runs from the start of its mark to the start of the next mark of its scope.

The sequences, each emitted once a call, in this order:

- ``step``: ``step_forward`` (the NHWC -> NCHW layout change and the
  forward in train mode, BatchNorm statistics included), ``step_loss``
  (the loss from the head's outputs; of an IAuxDetect net, the lead
  heads' assignment and loss), ``step_aux`` (an IAuxDetect net only: the
  auxiliary heads' widened assignment, matched on the lead predictions,
  and their loss), ``step_backward`` (the loss's
  backward and any recomputed forward under ``remat`` or ``bn_remat``),
  ``step_sync`` (under a mesh only: the gradients' sum and the global loss
  parts), ``step_optimizer``, ``step_ema``, ``step_end``. ``eval_loss``
  emits none.
- ``aug``: ``aug_input`` (the pool's gather of metas and boxes; on the CPU
  also of the tiles; on CUDA, for assembled tiles, their identity index),
  ``aug_single`` (the single path: on CUDA its geometry and boxes and one
  launch of ``kernels/augment.py::warp_tiles``; then the mixup partner's
  enhance ops and its roll), ``aug_mosaic`` (the box
  padding, the mosaic: on CUDA its geometry and boxes and one launch that
  writes its rows into the batch's images; the boxes' ``index_copy``s;
  empty when T = 1 or no sample is flagged), ``aug_enhance`` (the batch's
  enhance ops), ``aug_mix`` (mixup, copy-paste, the box cap, the labels and
  the 1/255 scale), ``aug_end``. Eval mode emits none.

Reading them: in the Chrome trace that ``utils/timing.profile_trace``
writes, each mark is an event of category ``kernel`` named
``mark_<name>_kernel`` on the stream's row; a phase's length is the next
mark's ``ts`` less its own (microseconds). From a live
``torch.profiler.profile``, ``phases(device_marks(prof), "step")`` gives
each phase's mean milliseconds over the complete sequences in the trace.

On a CPU device ``mark`` launches nothing, on any machine. Inside
``recording()`` it also appends its name to the thread's list, which is how
the CPU tests check the sequences. A mark is no kernel of the JAX package's
port and moves no launch counter (``utils/capture.count``).
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

from ..kernels import _build

# the order of csrc/marks.cu's kernels: a mark's id is its index here
MARKS = ("step_forward", "step_loss", "step_aux", "step_backward", "step_sync", "step_optimizer",
         "step_ema", "step_end", "aug_input", "aug_single", "aug_mosaic", "aug_enhance", "aug_mix",
         "aug_end")
OPTIONAL = frozenset({"step_aux", "step_sync"})     # an IAuxDetect net's step; a mesh's step
_IDS = {name: i for i, name in enumerate(MARKS)}
KERNEL = re.compile(r"(^|[^A-Za-z0-9_])mark_([a-z_]+)_kernel")
_local = threading.local()              # .marks: the list of an active recording()


def mark(name: str, device: torch.device) -> None:
    """Mark the start of phase ``name`` on ``device``'s current stream."""
    i = _IDS[name]
    marks = getattr(_local, "marks", None)
    if marks is not None:
        marks.append(name)
    if device.type != "cuda":
        return
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(_build.library("marks").mark(i, stream), f"mark {name}")


@contextlib.contextmanager
def recording() -> Iterator[List[str]]:
    """The names this thread marks inside the block, in order (an enclosing
    recording sees none of them)."""
    outer = getattr(_local, "marks", None)
    _local.marks = []
    try:
        yield _local.marks
    finally:
        _local.marks = outer


def device_marks(prof) -> List[Tuple[str, int]]:
    """``(name, start_ns)`` of every mark kernel on the card in a finished
    ``torch.profiler.profile``, in time order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        m = KERNEL.search(e.name())
        if m and m.group(2) in _IDS:
            out.append((m.group(2), int(e.start_ns())))
    return sorted(out, key=lambda nt: nt[1])


def phases(marks: Sequence[Tuple[str, int]], scope: str) -> Dict[str, float]:
    """Each phase of ``scope`` ("step" or "aug") -> its mean milliseconds
    over the complete sequences of ``marks`` (``(name, start_ns)`` in time
    order): from the scope's first mark through ``<scope>_end`` with every
    mark in order, an optional one (``step_aux``, ``step_sync``) present or
    not. A sequence cut by either edge of the trace is left out; a phase's
    mean is over the sequences that hold it. Empty when none is complete."""
    order = [n for n in MARKS if n.startswith(scope + "_")]
    sums: Dict[str, List[float]] = {}
    run: List[Tuple[str, int]] = []
    for name, t in marks:
        if not name.startswith(scope + "_"):
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
            run = []            # out of order: not a complete sequence
            continue
        run.append((name, t))
        if name == order[-1]:
            for (a, ta), (_, tb) in zip(run, run[1:]):
                sums.setdefault(a, []).append((tb - ta) / 1e6)
            run = []
    return {n: sum(sums[n]) / len(sums[n]) for n in order if n in sums}
