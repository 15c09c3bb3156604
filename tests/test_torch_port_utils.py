"""The port's ``utils/timing.py`` on the CPU (pattern: tests/test_utils.py)."""
import os

import pytest
import torch

from yolo_continuous_tpu_torch.detect_api import resolve_device
from yolo_continuous_tpu_torch.utils.timing import (device_timer, profile_trace, select_device,
                                                    time_fn, timer)


def test_timer_decorator(capsys):
    @timer
    def f(x):
        return x + 1
    assert f(1) == 2
    assert "f cost:" in capsys.readouterr().out


def test_device_timer_decorator(capsys):
    @device_timer
    def g(x):
        return x * 2
    assert torch.equal(g(torch.ones(4)), torch.full((4,), 2.0))
    assert "g device cost:" in capsys.readouterr().out


def test_time_fn():
    calls = []
    dt = time_fn(lambda x: calls.append(x) or x * 2, torch.ones(8), iters=3, warmup=2)
    assert dt >= 0 and len(calls) == 5


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as logdir:
        torch.ones(64).cumsum(0)
    path = os.path.join(logdir, "trace.json")
    assert os.path.getsize(path) > 0 and "traceEvents" in open(path).read()


def test_select_device():
    assert select_device("cpu") == torch.device("cpu") == resolve_device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            select_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            select_device("cuda")
    with pytest.raises(ValueError):
        select_device("mps")
