"""The captured request's cache and launch accounting, on the CPU.

On CUDA ``Detector.__call__`` replays one ``utils/capture.CapturedCall`` per
``(conf_thres, nms_thres, max_det)`` and input shape (JAX's ``_build_infer``
and its ``_infer`` cache). Here ``CapturedCall`` is replaced by ``CpuGraph``,
which keeps the real ``__call__`` (copy in, replay, count, clone) and
replaces only the graph: its "replay" runs the captured function again and
writes the results into the same static outputs, as a replay writes the
same addresses. The CPU ``__call__`` stays the eager request, held to JAX's
``Detector``. yolov7-tiny (``cfg/chip_tiny.yaml``) at 64 px, batch 2.
"""
import collections
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_port import lively, spread_weights
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu_torch import detect_api
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax
from yolo_continuous_tpu_torch.utils import capture
from yolo_continuous_tpu_torch.utils.capture import CapturedCall, count

SIZE, CONF, IOU, MAX_DET = 64, 0.01, 0.45, 100
KEY = (CONF, IOU, MAX_DET)


class CpuGraph(CapturedCall):
    """``CapturedCall`` with its graph replaced, for CPU tensors: the
    function runs once into static outputs under a capture record; a replay
    runs it again and copies the results into those outputs in place."""

    made = []

    def __init__(self, fn, *examples):
        self._inputs = tuple(x.clone() for x in examples)
        record = []
        with capture._Recording(record):
            outs = fn(*self._inputs)
        self._single = isinstance(outs, torch.Tensor)
        self._outputs = (outs,) if self._single else tuple(outs)
        self._record = capture._merge(record)
        self.launches = {capture._label(t, k): n for t, k, n in self._record}
        self.graph = self
        self._fn = fn
        self.replays = 0
        CpuGraph.made.append(self)

    def replay(self):
        with capture._Recording([]):        # a replay's launches count through the record
            outs = self._fn(*self._inputs)
        for static, new in zip(self._outputs, (outs,) if self._single else outs):
            static.copy_(new)
        self.replays += 1


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and the many small ops of a 64 px request, each split over every
    core, then wait on each other's threads (seconds alone, minutes there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recorder(monkeypatch):
    CpuGraph.made = []
    monkeypatch.setattr(detect_api, "CapturedCall", CpuGraph)
    return CpuGraph


def _plan(tmp_path):
    cfg = yaml.safe_load(open("cfg/chip_tiny.yaml"))
    cfg.update(image_size=SIZE, save_dir=str(tmp_path) + "/")
    return TrainPlan(cfg)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """yolov7-tiny's weights spread from a seed, so that scores and boxes
    move with the weights (an init's scores all sit at 0.25)."""
    det = Detector(_plan(tmp_path_factory.mktemp("init")), device="cpu", seed=0)
    return spread_weights(det.model, 1).state_dict()


def _images(seed, bs=2):
    return np.random.RandomState(seed).rand(bs, SIZE, SIZE, 3).astype(np.float32)


def _equal(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cpu_call_is_the_eager_request_equal_to_jax(tmp_path):
    """On the CPU ``__call__`` is ``infer_eager``, captures nothing, and
    agrees with JAX's Detector as ``test_torch_port_detector.py`` holds it:
    valid equal, boxes and scores within 1e-4, classes equal."""
    cfg = yaml.safe_load(open("cfg/chip_tiny.yaml"))
    cfg.update(image_size=SIZE, save_dir=str(tmp_path) + "/")
    # the tree's shapes without running flax's init (seconds on the CPU)
    jax_det = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32, params={}, batch_stats={})
    tree = jax.eval_shape(lambda k, x: jax_det.model.init(k, x, False), jax.random.PRNGKey(0),
                          jnp.zeros((1, SIZE, SIZE, 3)))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
    rs = np.random.RandomState(3)
    params, stats = lively(tree["params"], rs), lively(tree["batch_stats"], rs)
    params["detect"] = {name: {k: v * 16.0 if k == "kernel" else v for k, v in conv.items()}
                        for name, conv in params["detect"].items()}
    jax_det = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32, params=params,
                          batch_stats=stats)
    det = Detector(TrainPlan(dict(cfg)), device="cpu",
                   state_dict=state_dict_from_jax(jax_det.spec, params, stats))
    x = _images(1)
    ours = det(x, *KEY)
    _equal(ours, det.infer_eager(x, *KEY))
    assert det._infer == {} and det._infer_key is None
    ours = [t.numpy() for t in ours]
    ref = [np.asarray(t) for t in jax_det(jnp.asarray(x), *KEY)]
    valid = ref[3]
    np.testing.assert_array_equal(ours[3], valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(ours[0][valid], ref[0][valid], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours[1][valid], ref[1][valid], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours[2][valid], ref[2][valid])


def test_one_capture_per_key_and_shape(recorder, tmp_path):
    """A new shape adds a capture under the key; a repeated one replays; a
    new key drops every graph, as JAX drops ``_infer``."""
    det = Detector(_plan(tmp_path), device="cpu", seed=0)
    a, b = _images(0), _images(1, bs=1)
    _equal(det._replay(a, *KEY), det.infer_eager(a, *KEY))
    _equal(det._replay(a, *KEY), det.infer_eager(a, *KEY))
    assert len(recorder.made) == 1 and recorder.made[0].replays == 2
    _equal(det._replay(b, *KEY), det.infer_eager(b, *KEY))
    assert len(recorder.made) == 2 and set(det._infer) == {
        ((2, SIZE, SIZE, 3), torch.float32), ((1, SIZE, SIZE, 3), torch.float32)}
    det._replay(a.astype(np.float64), *KEY)                 # the dtype is part of the shape key
    assert len(recorder.made) == 3 and len(det._infer) == 3
    for key in ((0.3, IOU, MAX_DET), (0.3, 0.6, MAX_DET), (0.3, 0.6, 50)):
        out = det._replay(a, *key)
        assert det._infer_key == key and len(det._infer) == 1
        _equal(out, det.infer_eager(a, *key))
    assert out[0].shape == (2, 50, 4)
    n = len(recorder.made)
    det._replay(a, *KEY)
    assert len(recorder.made) == n + 1 and det._infer_key == KEY


def _scaled(det, gain):
    return {k: v.float() * gain if k.endswith("conv.weight") else v.float()
            for k, v in det.model.state_dict().items()}


@pytest.mark.parametrize("change", ["swap_weights", "reload_weights", "calibrate",
                                    "load_quant_state"])
def test_weight_and_scale_changes_drop_the_graphs(recorder, weights, tmp_path, change):
    """Each of the four drops every graph (a graph reads weights and int8
    scales by address); the next call captures anew and serves the new
    weights or scales: it equals the eager request after the change, which
    differs from the request before it."""
    plan = _plan(tmp_path)
    quantize = change in ("calibrate", "load_quant_state")
    det = Detector(plan, device="cpu", state_dict=weights, quantize=quantize)
    x = _images(2)
    if quantize:
        det.calibrate(x)
    before = det._replay(x, *KEY)
    det._replay(_images(3, bs=1), *KEY)
    assert len(det._infer) == 2
    if change == "swap_weights":
        det.swap_weights(_scaled(det, 1.5))
    elif change == "reload_weights":
        torch.save(_scaled(det, 1.5), os.path.splitext(plan.save_path)[0] + ".pth")
        assert det.reload_weights() is True
    elif change == "calibrate":
        det.calibrate(x * 4.0)
    else:
        det.load_quant_state({k: v * 0.5 for k, v in det.model.quant_state().items()})
    assert det._infer == {} and det._infer_key is None
    after = det._replay(x, *KEY)
    assert len(recorder.made) == 3
    _equal(after, det.infer_eager(x, *KEY))
    assert not all(torch.equal(a, b) for a, b in zip(after[:2], before[:2]))


def test_quantized_detector_raises_before_any_capture(recorder, tmp_path):
    det = Detector(_plan(tmp_path), device="cpu", seed=0, quantize=True)
    with pytest.raises(RuntimeError, match="calibrate"):
        det._replay(_images(0), *KEY)
    assert recorder.made == []


def test_results_are_fresh_tensors_never_overwritten(recorder, weights, tmp_path):
    """Two calls give distinct tensors; the second call, on other images,
    leaves the first call's results as they were."""
    det = Detector(_plan(tmp_path), device="cpu", state_dict=weights)
    a, b = _images(4), _images(5)
    first = det._replay(a, *KEY)
    kept = [t.clone() for t in first]
    second = det._replay(b, *KEY)
    _equal(first, kept)
    _equal(second, det.infer_eager(b, *KEY))
    statics = recorder.made[0]._outputs
    for t1, t2, s in zip(first, second, statics):
        assert t1.data_ptr() != t2.data_ptr() and s.data_ptr() not in (t1.data_ptr(),
                                                                        t2.data_ptr())
    assert not torch.equal(first[1], second[1])


def _kernel():
    pass


def test_counts_move_by_the_capture_record_on_each_replay():
    """Warm-up and capture count into their records and leave the counters;
    each replay adds the capture's record: captured launches x replays."""
    _kernel.launches = 0
    routes = collections.Counter()

    def fn(x):
        count(_kernel, 2)
        count(routes, key="gemm")
        count(_kernel)
        return x * 2.0

    call = CpuGraph(fn, torch.ones(3))
    assert _kernel.launches == 0 and routes == {}
    assert call.launches == {"_kernel": 3, "route gemm": 1}
    for _ in range(4):
        torch.testing.assert_close(call(torch.full((3,), 5.0)), torch.full((3,), 10.0))
    assert _kernel.launches == 12 and routes == {"gemm": 4}
    count(_kernel)                      # outside any graph, as before
    assert _kernel.launches == 13
    record = []
    with capture._Recording(record):
        count(_kernel)
        with pytest.raises(capture.CaptureError, match="already"):
            capture._Recording([]).__enter__()
    assert record == [(_kernel, None, 1)] and _kernel.launches == 13


def test_a_call_takes_only_the_captured_shape_and_dtype():
    call = CpuGraph(lambda x: x + 1.0, torch.zeros(2, 3))
    for bad in (torch.zeros(3, 2), torch.zeros(2, 3, dtype=torch.float64)):
        with pytest.raises(ValueError, match="captured for"):
            call(bad)
    with pytest.raises(ValueError, match="takes 1 inputs"):
        call(torch.zeros(2, 3), torch.zeros(2, 3))


def test_capture_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA"):
        CapturedCall(lambda x: x, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        CapturedCall(lambda: None)
