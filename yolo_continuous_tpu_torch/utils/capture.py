"""One call of fixed-shape CUDA tensors, captured once as a CUDA graph and replayed.

The port's counterpart of ``jax.jit`` for one call. JAX's ``Detector``
compiles forward, decode and NMS into one program per
``(conf_thres, nms_thres, max_det)`` (``_build_infer``,
``yolo_continuous_tpu/detect_api.py:220-245``), which jit caches per input
shape; the port's ``Detector`` captures the same request into one
``CapturedCall`` per key and shape and replays it. JAX's ``Trainer`` jits
its train step with the state donated (``jitted_train_step``,
``yolo_continuous_tpu/train/train_loop.py:202-217``); the port's captures
it as a ``CapturedStep``, a sibling for a call that updates its state in
place (see its docstring: its first call is the warm-up and a real step).

``CapturedCall(fn, *examples)``:

1. allocates static input buffers on the card with the examples' shapes and
   dtypes, and copies the examples in;
2. warms ``fn`` up once on the device's capture stream, so that what runs
   once per process or stream (cuBLAS and cuDNN handles and workspaces, the
   kernels' ``nvcc`` builds and library loads) happens before the capture;
3. captures ``fn`` of the static buffers on that stream into a private
   memory pool, in ``thread_local`` mode: other threads (a loader staging on
   its own stream, another model's serving worker) go on working meanwhile.
   PyTorch allows one capture at a time in a process, so a warm-up and its
   capture hold ``_CAPTURE_LOCK``, and all captures share one side stream a
   device (``_STREAMS``), whose per-stream state is then set up once;
4. on each call copies the caller's inputs into the static buffers, replays
   the graph on the current stream and returns clones of the static outputs:
   a result held across calls is never overwritten by a later one, as JAX
   returns fresh arrays.

Every operand a captured kernel reads lives in the static buffers, the
graph's pool or the model's parameters and buffers, whose addresses the
graph keeps (a kernel's TMA tensor maps, encoded on the host with those
addresses, are baked into its node). An owner that rebinds a tensor the
graph reads drops the ``CapturedCall`` (``Detector._drop_graphs``).

Launch counts: the kernels' wrappers count their launches through ``count``.
While a thread warms up or captures, its counts go into that stage's record
and not to the counters: the warm-up is set-up, and a captured launch runs
only when the graph is replayed. Each replay adds the capture's record to
the counters, so a counter reads the captured launches times the replays,
plus the launches made outside any graph.

Nothing falls back: a capture or a replay that fails raises
``CaptureError``, naming the stage and the kernels recorded until then.
A ``CapturedCall`` is not thread-safe: one caller at a time.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, List, Tuple

import torch

_CAPTURE_LOCK = threading.Lock()
_STREAMS: Dict[int, torch.cuda.Stream] = {}     # device index -> its capture stream
_local = threading.local()          # .record: the list a warm-up or capture counts into


class CaptureError(RuntimeError):
    """A CUDA graph's capture or replay failed; nothing ran in its place."""


@contextlib.contextmanager
def _no_collection():
    """No cyclic garbage collection during a capture: a finalizer run inside
    it, on its thread (a dropped graph's reset, ``cudaGraphExecDestroy``),
    is an API call that invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _stream(device: torch.device) -> torch.cuda.Stream:
    """The device's capture stream, after the work queued so far on the
    current stream."""
    if device.index not in _STREAMS:
        _STREAMS[device.index] = torch.cuda.Stream(device)
    stream = _STREAMS[device.index]
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def count(target, n: int = 1, key=None) -> None:
    """Count ``n`` launches: ``target.launches += n`` (a kernel wrapper), or
    ``target[key] += n`` (a ``collections.Counter`` of routes). While this
    thread warms up or captures a ``CapturedCall``, into its record instead."""
    record = getattr(_local, "record", None)
    if record is not None:
        record.append((target, key, n))
    elif key is None:
        target.launches += n
    else:
        target[key] += n


def _label(target, key) -> str:
    return getattr(target, "__name__", "counter") if key is None else f"route {key}"


def _merge(record: List[tuple]) -> List[list]:
    """A record's entries summed per counter, in order of first launch."""
    merged: Dict[tuple, list] = {}
    for target, key, n in record:
        slot = merged.setdefault((id(target), key), [target, key, 0])
        slot[2] += n
    return list(merged.values())


class _Recording:
    """Counts of this thread go into ``record`` inside the ``with``."""

    def __init__(self, record: list):
        self.record = record

    def __enter__(self):
        if getattr(_local, "record", None) is not None:
            raise CaptureError("a CapturedCall is already warming up or capturing on this thread")
        _local.record = self.record
        return self.record

    def __exit__(self, *exc):
        _local.record = None


class CapturedCall:
    """``fn(*inputs)`` of CUDA tensors, captured as a CUDA graph from
    ``examples`` (see the module's docstring). ``fn`` returns a tensor or a
    tuple of tensors; a call takes inputs of the examples' shapes and dtypes
    (on the card or the host) and returns fresh tensors.

    ``launches`` holds, per kernel wrapper, the launches one replay runs;
    ``warmup_ms`` and ``capture_ms`` the host time of the two set-up stages;
    ``pool_bytes`` the memory the capture reserved for the graph's pool (the
    device's reserved bytes before and after it)."""

    _keys = None            # the output dict's keys, where ``fn`` returns a dict

    def __init__(self, fn: Callable, *examples: torch.Tensor):
        self._static_inputs(examples)
        for buf, x in zip(self._inputs, examples):
            buf.copy_(x)
        with _CAPTURE_LOCK:
            outs = self._warm_up_and_capture(fn, self._inputs[0].device)
        self._set_outputs(outs)

    def _static_inputs(self, examples) -> None:
        if not examples or any(not isinstance(x, torch.Tensor) or x.device.type != "cuda"
                               for x in examples):
            raise ValueError(f"{type(self).__name__} takes one or more example tensors on a "
                             f"CUDA device")
        device = examples[0].device
        self._inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=device) for x in examples)

    def _set_outputs(self, outs) -> None:
        """The static outputs of a tensor, a tuple or a dict of tensors."""
        self._single = isinstance(outs, torch.Tensor)
        self._keys = tuple(outs) if isinstance(outs, dict) else None
        self._outputs: Tuple[torch.Tensor, ...] = (
            (outs,) if self._single else tuple(outs.values()) if self._keys else tuple(outs))

    def _fresh_outputs(self):
        """Clones of the static outputs, in the structure ``fn`` returned."""
        outs = tuple(t.clone() for t in self._outputs)
        if self._keys is not None:
            return dict(zip(self._keys, outs))
        return outs[0] if self._single else outs

    def _warm_up_and_capture(self, fn: Callable, device: torch.device):
        stream = _stream(device)
        t0 = time.perf_counter()
        warm: list = []
        try:
            with _Recording(warm), torch.cuda.stream(stream):
                fn(*self._inputs)
        except Exception as e:
            e.add_note(f"CapturedCall: raised in the warm-up, before any capture "
                       f"(kernels launched: {self._describe(warm)})")
            raise
        stream.synchronize()
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        return self._capture(fn, stream, device)

    def _capture(self, fn: Callable, stream: torch.cuda.Stream, device: torch.device):
        """Capture ``fn`` of the static inputs on ``stream``; its outputs."""
        t1 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        record: list = []
        with _Recording(record), torch.cuda.stream(stream), _no_collection():
            reserved = torch.cuda.memory_reserved(device)
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs = fn(*self._inputs)
            except BaseException as e:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass        # the capture is invalid already; e says why
                if not isinstance(e, Exception):
                    raise
                raise CaptureError(f"CUDA graph capture failed after recording "
                                   f"{self._describe(record)}: {e}") from e
            try:
                self.graph.capture_end()
            except RuntimeError as e:
                raise CaptureError(f"CUDA graph capture could not end and instantiate "
                                   f"({self._describe(record)}): {e}") from e
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.capture_ms = (time.perf_counter() - t1) * 1e3
        self._record = _merge(record)
        self.launches = {_label(t, k): n for t, k, n in self._record}
        return outs

    @staticmethod
    def _describe(record: list) -> str:
        merged = _merge(record)
        if not merged:
            return "no kernel of the port"
        return ", ".join(f"{_label(t, k)} x{n}" for t, k, n in merged) + \
            f" (last: {_label(*record[-1][:2])})"

    def _copy_in(self, inputs) -> None:
        if len(inputs) != len(self._inputs):
            raise ValueError(f"{type(self).__name__} takes {len(self._inputs)} inputs, "
                             f"got {len(inputs)}")
        for buf, x in zip(self._inputs, inputs):
            if tuple(x.shape) != tuple(buf.shape) or x.dtype != buf.dtype:
                raise ValueError(f"{type(self).__name__} was captured for {tuple(buf.shape)} "
                                 f"{buf.dtype}, got {tuple(x.shape)} {x.dtype}")
            buf.copy_(x)

    def __call__(self, *inputs):
        self._copy_in(inputs)
        try:
            self.graph.replay()
        except RuntimeError as e:
            raise CaptureError(f"CUDA graph replay failed ({self._describe(self._record)}): "
                               f"{e}") from e
        for target, key, n in self._record:
            count(target, n, key)
        return self._fresh_outputs()


class CapturedStep(CapturedCall):
    """``fn(*inputs)`` that updates state in place (a train step), as one
    CUDA graph: the port's counterpart of ``jax.jit`` with donated state.

    ``CapturedCall``'s warm-up would run ``fn`` once more than asked (a step
    too many), so nothing runs at construction. The first call copies its
    inputs in and runs ``fn`` eagerly on the capture stream: that is the
    warm-up and the call's own step, whose launches count as launched. The
    warm-up's cached blocks are released (``torch.cuda.empty_cache``), so
    that the graph's pool takes their place rather than adding to them,
    and ``fn`` is captured; the first call returns the warm-up's outputs.
    Later calls copy in, replay and return clones of the static outputs, as
    ``CapturedCall``. Host state (counters, schedules) stays outside ``fn``;
    ``fn`` reads per-call scalars from its inputs (device tensors), since a
    Python number is baked into the graph.

    A failed capture raises ``CaptureError``: the warm-up's step stands (the
    state moved once), and every later call raises the same error without
    running anything (so does an error of the warm-up). ``fn`` is let go
    after the first call, so that an owner whose ``fn`` refers back to it
    frees its graph with it, not at a later collection. ``warmup_ms``
    includes the wait for the warm-up to finish on the card."""

    def __init__(self, fn: Callable, *examples: torch.Tensor):
        self._static_inputs(examples)
        self._fn, self.graph, self._error = fn, None, None

    def __call__(self, *inputs):
        if self._error is not None:
            raise self._error
        if self.graph is not None:
            return super().__call__(*inputs)
        self._copy_in(inputs)
        with _CAPTURE_LOCK:
            try:
                return self._warm_up_and_capture(self._fn, self._inputs[0].device)
            except Exception as e:
                self.graph, self._error = None, e
                raise
            finally:
                self._fn = None     # ``fn`` (a Trainer's bound step) would close a cycle

    def _warm_up_and_capture(self, fn: Callable, device: torch.device):
        """The warm-up's outputs; the static ones are the capture's."""
        stream = _stream(device)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            outs = fn(*self._inputs)
        stream.synchronize()
        self.warmup_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.empty_cache()
        self._set_outputs(self._capture(fn, stream, device))
        return outs
