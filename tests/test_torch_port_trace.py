"""Phase marks (``utils/trace``) in the train step and the augmentation, on the CPU.

Each mark launches an empty kernel named ``mark_<name>_kernel`` on the
card (``csrc/marks.cu``), inside the captured graphs; on the CPU it launches
nothing and, inside ``trace.recording()``, records its name. Here: the
sequences of the eager step (with and without ``bn_remat``), of the step
through ``_replayed_step`` with its graph replaced by ``CpuStep``, of a
gloo mesh's step, of the augmentation from tiles (T = 1 and T = 4) and
from the device pool; none from eval mode and ``eval_loss``; results bit
for bit those of a run outside any recording; no launch counter moved;
the names and order of ``csrc/marks.cu`` against ``trace.MARKS``; and the
reduction of a device trace's marks to phase times (``trace.phases``). On
the card: ``tests/test_torch_port_cuda.py``.
"""
import re

import numpy as np
import pytest
import torch

from _torch_port import tiny_plan_cfg
from test_torch_port_augment_capture import _batch as aug_batch
from test_torch_port_augment_capture import _equal, _trainer
from test_torch_port_train_capture import CpuStep, _equal_states
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.kernels import _build, bin_decode, decode, fused_conv, nms, staging
from yolo_continuous_tpu_torch.nn import quant
from yolo_continuous_tpu_torch.train import train_loop
from yolo_continuous_tpu_torch.train.train_loop import Trainer
from yolo_continuous_tpu_torch.utils import trace

STEP = ["step_forward", "step_loss", "step_backward", "step_optimizer", "step_ema", "step_end"]
MESH_STEP = STEP[:3] + ["step_sync"] + STEP[3:]
AUX_STEP = STEP[:2] + ["step_aux"] + STEP[2:]       # an IAuxDetect net's step
AUG = ["aug_input", "aug_single", "aug_mosaic", "aug_enhance", "aug_mix", "aug_end"]
HYPER = [(0.01, 0.1, 0.9), (0.02, 0.08, 0.92)]


def _step_batch(seed):
    rs = np.random.RandomState(seed)
    labels = np.zeros((2, 8, 5), np.float32)
    lmask = np.zeros((2, 8), bool)
    for b in range(2):
        for g in range(2 + b):
            labels[b, g] = [rs.randint(2), rs.uniform(.25, .75), rs.uniform(.25, .75),
                            rs.uniform(.15, .5), rs.uniform(.15, .5)]
            lmask[b, g] = True
    return rs.rand(2, 64, 64, 3).astype(np.float32), labels, lmask


def _counters():
    """Every launch counter of the port: the kernels' wrappers and the int8
    routes."""
    wrappers = (decode.decode_outputs_cuda, bin_decode.decode_outputs_bin_cuda,
                fused_conv.fused_pointwise_conv_cuda, nms.nms_suppress, nms.nms_suppress_tiled,
                staging.stage_letterbox)
    return [w.launches for w in wrappers] + [dict(quant.route_calls)]


@pytest.fixture
def no_launch(monkeypatch):
    """A mark that reached the card's library would raise; the counters are
    read before and checked after."""
    def refuse(name):
        raise AssertionError(f"a library was loaded on the CPU: {name}")
    monkeypatch.setattr(_build, "library", refuse)
    before = _counters()
    yield
    assert _counters() == before


@pytest.mark.parametrize("bn_remat", [False, True])
def test_the_eager_step_marks_its_phases_once_a_step(no_launch, bn_remat):
    """Two eager steps of an IAuxDetect net under a recording: the seven
    marks (``step_aux`` after ``step_loss``) once a step, in order; metrics
    and states bit for bit those of a twin outside it."""
    cfg = dict(tiny_plan_cfg("IAuxDetect", 64), bn_remat=bn_remat)
    trainers = [Trainer(TrainPlan(dict(cfg)), device="cpu") for _ in range(2)]
    states = [tr.init_state(seed=0) for tr in trainers]
    for i, hyper in enumerate(HYPER):
        batch = _step_batch(i)
        with trace.recording() as marks:
            _, got = trainers[0].train_step(states[0], *batch, *hyper)
        _, want = trainers[1].train_step(states[1], *batch, *hyper)
        assert marks == AUX_STEP
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    _equal_states(states[0], states[1])


def test_the_compiled_step_marks_each_call_and_eval_loss_none(no_launch, monkeypatch):
    """``_replayed_step`` (its graph replaced by ``CpuStep``): the first call
    (warm-up and capture) and each replay mark the six once; the eager and
    compiled eval loss mark nothing."""
    monkeypatch.setattr(train_loop, "CapturedStep", CpuStep)
    tr = Trainer(TrainPlan(tiny_plan_cfg("Detect", 64)), device="cpu")
    state = tr.init_state(seed=0)
    for i in range(3):
        with trace.recording() as marks:
            tr._replayed_step(state, *_step_batch(i), *HYPER[0])
        assert marks == STEP, i
    with trace.recording() as marks:
        tr.eval_loss(state, *_step_batch(5))
        tr.jitted_eval_loss()(state, *_step_batch(5))
    assert marks == []


def test_a_mesh_step_marks_the_sync(no_launch, tmp_path):
    """A world-of-one gloo mesh's step marks ``step_sync`` between the
    backward and the optimizer."""
    from yolo_continuous_tpu_torch.parallel import distributed as D
    from yolo_continuous_tpu_torch.parallel import mesh as M
    D.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu", timeout_s=30)
    try:
        tr = Trainer(TrainPlan(tiny_plan_cfg("Detect", 64)), device="cpu",
                     mesh=M.make_mesh(1, 1))
        state = M.shard_params(tr.mesh, tr.init_state(seed=0))
        batch = M.shard_batch(tr.mesh, _step_batch(0))
        with trace.recording() as marks:
            tr.jitted_train_step()(state, *batch, *HYPER[0])
            tr.jitted_eval_loss()(state, *batch)
        assert marks == MESH_STEP
    finally:
        D.shutdown()


AUG_CASES = {  # name: source, T, mosaic count n
    "tiles T=1": ("tiles", 1, 0),
    "tiles T=4 n=0": ("tiles", 4, 0),
    "tiles T=4 n=2": ("tiles", 4, 2),
    "pool T=4 n=3": ("pool", 4, 3),
    "pool T=1": ("pool", 1, 0),
}


@pytest.mark.parametrize("case", sorted(AUG_CASES))
def test_the_augmentation_marks_its_phases_once_a_call(no_launch, case):
    """``augment_batch`` and ``augment_batch_from_pool`` in train mode: the
    six marks once a call, in order, also where the mosaic phase is empty
    (T = 1, or no sample flagged); the results bit for bit those of a call
    outside the recording. Eval mode marks nothing."""
    source, T, n = AUG_CASES[case]
    tr = _trainer()
    batch, pool = aug_batch(source, T, n, seed=len(case))
    draw = tr.draw(3, T, *batch[-2:])
    with trace.recording() as marks:
        got = tr.augment(draw, batch, pool=pool)
    assert marks == AUG
    _equal(got, tr.augment(draw, batch, pool=pool))
    with trace.recording() as marks:
        tr.augment(None, batch, False, pool=pool)
    assert marks == []


def test_a_mark_on_the_cpu_launches_nothing_even_with_a_card(no_launch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with trace.recording() as marks:
        trace.mark("step_forward", torch.device("cpu"))
    assert marks == ["step_forward"]
    with pytest.raises(KeyError):
        trace.mark("step_unknown", torch.device("cpu"))


def test_a_mark_on_a_cuda_device_launches_its_id_on_the_current_stream(monkeypatch):
    """The launch path, with the library and the stream faked: the mark's
    index in ``MARKS`` and the current stream's handle; an error code
    raises."""
    calls, codes = [], [0, 1]

    class Lib:
        def mark(self, i, stream):
            calls.append((i, stream))
            return codes.pop(0)

    class Stream:
        cuda_stream = 0x5EED

    monkeypatch.setattr(_build, "library", lambda name: Lib() if name == "marks" else None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    cuda = torch.device("cuda", 0)
    trace.mark("aug_mix", cuda)
    with pytest.raises(RuntimeError, match="mark step_end"):
        trace.mark("step_end", cuda)
    assert calls == [(trace.MARKS.index("aug_mix"), 0x5EED),
                     (trace.MARKS.index("step_end"), 0x5EED)]


def test_recordings_nest_and_end():
    cpu = torch.device("cpu")
    with trace.recording() as outer:
        trace.mark("aug_input", cpu)
        with trace.recording() as inner:
            trace.mark("aug_end", cpu)
        trace.mark("step_end", cpu)
    trace.mark("step_loss", cpu)
    assert outer == ["aug_input", "step_end"] and inner == ["aug_end"]


def test_the_kernels_of_marks_cu_are_the_marks_in_order():
    """``csrc/marks.cu`` defines one kernel a mark and launches mark i as
    the i-th entry of its table: both in ``trace.MARKS``' order."""
    src = (_build.CSRC / "marks.cu").read_text()
    assert re.findall(r"^MARK\((\w+)\)$", src, re.M) == list(trace.MARKS)
    table = re.search(r"kMarks\[\] = \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"mark_(\w+?)_kernel", table) == list(trace.MARKS)
    assert set(AUX_STEP + AUG + ["step_sync"]) == set(trace.MARKS)


def _at(names, t0=0, step_ns=1_000_000):
    """Marks ``names`` at t0, t0 + step, ... (ns)."""
    return [(n, t0 + i * step_ns) for i, n in enumerate(names)]


def test_phases_of_complete_sequences_only():
    """A sequence cut at the trace's start (no first mark) or end (no
    ``_end``), or out of order, is left out; each phase is the mean of the
    next mark's start less its own over the complete ones, in ms; the other
    scope's marks in between change nothing."""
    cut_start = _at(STEP[2:], 0)
    one = _at(STEP, 10_000_000, 2_000_000)                   # 2 ms a phase
    aug = _at(AUG, 22_000_000, 500_000)
    two = _at(STEP, 30_000_000, 4_000_000)                   # 4 ms a phase
    swapped = _at([STEP[0], STEP[2], STEP[1]] + STEP[3:], 60_000_000)
    cut_end = _at(STEP[:4], 80_000_000)
    marks = sorted(cut_start + one + aug + two + swapped + cut_end, key=lambda m: m[1])
    got = trace.phases(marks, "step")
    assert list(got) == STEP[:-1]
    assert all(v == pytest.approx(3.0) for v in got.values())
    assert trace.phases(marks, "aug") == {n: pytest.approx(0.5) for n in AUG[:-1]}
    assert trace.phases(cut_start + cut_end, "step") == {}
    assert trace.phases([], "aug") == {}


def test_phases_take_the_sync_where_a_step_has_it():
    marks = _at(MESH_STEP, 0, 1_000_000) + _at(STEP, 10_000_000, 3_000_000)
    got = trace.phases(marks, "step")
    assert got["step_sync"] == pytest.approx(1.0)             # the mesh step's alone
    assert got["step_forward"] == pytest.approx(2.0)          # the mean of 1 and 3
    assert list(got) == MESH_STEP[:-1]
