"""Timing and profiling helpers on PyTorch.

Counterpart of ``yolo_continuous_tpu/utils/timing.py``: ``timer``
(``utils/helper_torch.py:10-20``), ``device_timer`` and ``time_fn``, which
wait for the card with ``torch.cuda.synchronize()`` where JAX blocks on its
results, ``profile_trace`` on ``torch.profiler`` (a Chrome trace), and
``select_device``, which is ``detect_api.resolve_device``: ``cuda`` by
default, raising when there is no card.
"""
from __future__ import annotations

import contextlib
import os
import time
from functools import wraps

import torch

from ..detect_api import resolve_device


def _sync(device=None) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


def timer(func):
    """Print the wall time of each call; helper_torch.py:10-20."""
    @wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.time()
        result = func(*args, **kwargs)
        print("{0} cost:\t{1:.3f}s".format(func.__name__, time.time() - t0))
        return result
    return wrapper


def device_timer(func):
    """Like ``timer``, but waits for the card's work before reading the clock."""
    @wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        _sync()
        print("{0} device cost:\t{1:.3f}s".format(func.__name__, time.perf_counter() - t0))
        return result
    return wrapper


def time_fn(fn, *args, iters: int = 10, warmup: int = 1) -> float:
    """Mean seconds a call of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls, the card's queue drained before and after."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def profile_trace(logdir: str = "runs/torch-trace"):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a
    card); writes ``<logdir>/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def select_device(device: str = "") -> torch.device:
    """The ``torch.device`` to run on: ``cuda`` unless ``device`` says
    ``cpu``; raises when ``cuda`` is asked for and there is no card."""
    return resolve_device(device or "cuda")
