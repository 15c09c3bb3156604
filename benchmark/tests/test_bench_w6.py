"""The ``train_aux`` driver (``harness/train_aux.py``) of ``yolov7-w6.train.stager``
on a cut-down cell on the CPU: W6's rows at a sixteenth of the widths,
128 px, two images a batch. The sound run agrees with the plain reference
(``reference/p6_train.py``) and reads ``correct`` true; the fp8 control
and the auxiliary heads' planted faults (``controls_aux.py``: the auxiliary
loss dropped, the auxiliary cells narrowed to the lead's) read ``correct``
false."""
from __future__ import annotations

import copy
import json
import time

import pytest

from harness import common as C

from _small import bench

import controls_aux

NAME = "yolov7-w6.train.stager"
SEED = 2 ** 35 + 11


def small_w6(size: int = 128) -> dict:
    c = copy.deepcopy(C.cell(NAME, bench()))
    c["config"].update(image_size=size, width_multiple=1 / 16)
    c["traffic"]["train"].update(width=size + size // 4, height=size - size // 16, batch=2,
                                 images=8)
    return c


def test_a_w6_train_step_agrees_with_the_reference_on_the_cpu():
    import run
    chk = {}
    res = run.execute(NAME, SEED, 0.5, False, "cpu", bench(), small_w6(),
                      t_start=time.perf_counter(), numbers=chk)
    assert chk["aug_image_off"] == 0.0 and chk["aug_label_gap"] < 1e-6
    assert chk["aug_mask_diff"] == 0.0 and chk["loss_finite"] == 0.0
    # fp32 on both sides and the program's batches: the first step agrees to
    # rounding, with the same positives of both assignments
    assert chk["loss_gap_first"] < 1e-6 and chk["grad_gap"] < 1e-5
    assert chk["fg_gap_first"] == 0.0 and chk["fg_aux_gap_first"] == 0.0
    assert res["correct"]
    assert res["metrics"]["train_img_s"]["value"] > 0


def test_a_traced_w6_run_keeps_the_marks_without_a_card():
    """On the CPU the port launches no mark kernel: ``marks`` is empty and
    ``step_aux_ms`` reads nothing, without raising."""
    import run
    res = run.execute(NAME, SEED, 0.5, True, "cpu", bench(), small_w6(),
                      t_start=time.perf_counter())
    assert "step_aux_ms" not in res["metrics"]
    assert "train_mfu" in res["metrics"]


def test_the_step_aux_reader_takes_complete_steps():
    from harness.marks import phases
    step = ["step_forward", "step_loss", "step_aux", "step_backward", "step_optimizer",
            "step_ema", "step_end"]
    marks = [[n, 10_000_000 + i * 2_000_000] for i, n in enumerate(step)]
    marks += [[n, 40_000_000 + i * 4_000_000] for i, n in enumerate(step)]
    marks += [[n, 90_000_000 + i * 1_000_000] for i, n in enumerate(step[:4])]   # cut
    reader = C.reader("step_aux_ms")
    assert reader({"marks": marks}) == pytest.approx(3.0)
    assert phases(marks, "step")["step_loss"] == pytest.approx(3.0)
    assert reader({"marks": [m for m in marks if m[0] != "step_aux"]}) is None
    assert reader({}) is None


@pytest.mark.parametrize("what", ["control", "aux_dropped", "aux_narrowed"])
def test_the_control_and_the_auxiliary_faults_are_not_correct(what):
    out = controls_aux.run_one(NAME, what, SEED, 0.5, "cpu", small_w6())
    assert not out["correct"], json.dumps(out)
