"""The compiled NMS's cache and routes, on the CPU.

JAX jits ``nms_single`` and ``batched_nms`` (``_nms_single_jit``,
``_batched_nms_jit``); on a CUDA tensor the port replays one captured CUDA
graph per ``(device, shape, dtype, conf_thres, iou_thres, max_det,
per_class)`` from a cache of the ``NMS_GRAPHS`` most recent keys
(``ops/nms._compiled``). Here the compiled route is forced on CPU tensors
and ``CapturedCall`` is replaced by ``CpuGraph`` (``test_torch_port_capture.py``'s
pattern): the real ``__call__`` (copy in, replay, count, clone) around a
"graph" whose replay runs the captured function again. Every compiled
result is held to JAX's jitted function (exact keep-sets, as
``test_torch_port_nms.py``) and to the eager one bit for bit.
"""
import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from yolo_continuous_tpu.ops import nms as jax_nms
from yolo_continuous_tpu_torch import detect_api
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.ops import nms
from yolo_continuous_tpu_torch.utils import capture
from yolo_continuous_tpu_torch.utils.capture import CapturedCall, CaptureError


class CpuGraph(CapturedCall):
    """``CapturedCall`` with its graph replaced, for CPU tensors (see
    ``test_torch_port_capture.py``)."""

    made = []

    def __init__(self, fn, *examples, pool=None, inputs=None):
        capture._not_nested(type(self).__name__)
        self._inputs = tuple(x.clone() for x in examples)
        record = []
        with capture._Recording(record):
            outs = fn(*self._inputs)
        self._single = isinstance(outs, torch.Tensor)
        self._outputs = (outs,) if self._single else tuple(outs)
        self._record = capture._merge(record)
        self.launches = {capture._label(t, k): n for t, k, n in self._record}
        self.graph, self._fn, self.replays = self, fn, 0
        CpuGraph.made.append(self)

    def replay(self):
        with capture._Recording([]):
            outs = self._fn(*self._inputs)
        for static, new in zip(self._outputs, (outs,) if self._single else outs):
            static.copy_(new)
        self.replays += 1


@pytest.fixture(autouse=True)
def fresh_cache():
    nms._graphs.clear()
    yield
    nms._graphs.clear()


@pytest.fixture
def compiled(monkeypatch):
    """The compiled route on CPU tensors, through ``CpuGraph``."""
    CpuGraph.made = []
    monkeypatch.setattr(nms, "CapturedCall", CpuGraph)
    monkeypatch.setattr(nms, "_replays", lambda pred: True)
    return CpuGraph


def _preds(seed, bs=2, n=600, nc=4):
    """Rows whose scores are spread at least 1/n apart (no top-k ties)."""
    rs = np.random.RandomState(seed)
    p = rs.rand(bs, n, 5 + nc).astype(np.float32)
    p[..., 2:4] = p[..., 2:4] * 0.2 + 0.02
    p[..., 4] = np.stack([rs.permutation(n) for _ in range(bs)]) / n + 0.5 / n
    p[..., 5:] *= 0.9
    p[np.arange(bs)[:, None], np.arange(n)[None], 5 + rs.randint(0, nc, (bs, n))] = 1.0
    return p


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


def test_cpu_tensors_take_the_eager_function():
    p = torch.from_numpy(_preds(0))
    _equal(nms.batched_nms(p, 0.3, 0.45, 50), nms.nms_core(p, 0.3, 0.45, 50))
    _equal(nms.nms_single(p[0], 0.3, 0.45, 50), [t[0] for t in nms.nms_core(p[:1], 0.3, 0.45, 50)])
    assert len(nms._graphs) == 0


@pytest.mark.parametrize("fn,max_det,per_class", [("batched_nms", 300, True),
                                                  ("batched_nms", 700, False),
                                                  ("nms_single", 300, True),
                                                  ("nms_single", 700, True)])
def test_compiled_nms_equals_jax_jitted(compiled, fn, max_det, per_class):
    """The compiled route (a capture, then a replay) against JAX's jitted
    function: keep-sets exact, boxes within 1e-6, scores and classes exact;
    and bit-equal to the eager function. max_det 700 > 600 rows pads."""
    p = _preds(max_det + per_class)
    if fn == "nms_single":
        p = p[0]
    score = (p[..., 4] * p[..., 5:].max(-1)).reshape(-1, p.shape[-2])
    assert min(np.diff(np.sort(row[row >= 0.3])).min() for row in score) > 1e-5   # no ties
    x = torch.from_numpy(p)
    ours = getattr(nms, fn)(x, 0.3, 0.45, max_det, per_class)
    assert len(compiled.made) == 1 and compiled.made[0].replays == 1
    ref = [np.asarray(t) for t in getattr(jax_nms, fn)(jnp.asarray(p), 0.3, 0.45, max_det,
                                                        per_class)]
    keep = ref[3]
    np.testing.assert_array_equal(ours[3].numpy(), keep)
    assert 0 < keep.sum() < keep.size
    np.testing.assert_allclose(ours[0].numpy()[keep], ref[0][keep], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours[1].numpy()[keep], ref[1][keep])
    np.testing.assert_array_equal(ours[2].numpy()[keep], ref[2][keep])
    core = nms.nms_core(x if fn == "batched_nms" else x[None], 0.3, 0.45, max_det, per_class)
    _equal(ours, core if fn == "batched_nms" else [t[0] for t in core])


@pytest.mark.parametrize("change", ["conf_thres", "iou_thres", "max_det", "per_class", "shape",
                                    "dtype", "function"])
def test_one_capture_per_key(compiled, change):
    """A repeated key replays its graph; each of the key's parts makes a new
    one (the thresholds too: K1 and K2 take ``iou_thres`` as a launch
    argument, baked into the graph); every result equals the eager one."""
    p = torch.from_numpy(_preds(1))
    args = dict(conf_thres=0.3, iou_thres=0.45, max_det=100, per_class=True)
    first = nms.batched_nms(p, **args)
    again = nms.batched_nms(p + 0.0, **args)
    assert len(compiled.made) == 1 and compiled.made[0].replays == 2
    _equal(again, first)
    other = {"conf_thres": dict(args, conf_thres=0.5), "iou_thres": dict(args, iou_thres=0.6),
             "max_det": dict(args, max_det=50), "per_class": dict(args, per_class=False)}
    if change in other:
        out, want = nms.batched_nms(p, **other[change]), nms.nms_core(p, **other[change])
    elif change == "shape":
        out, want = nms.batched_nms(p[:1], **args), nms.nms_core(p[:1], **args)
    elif change == "dtype":
        out, want = nms.batched_nms(p.double(), **args), nms.nms_core(p.double(), **args)
    else:
        out = nms.nms_single(p[0], **args)
        want = [t[0] for t in nms.nms_core(p[:1], **args)]
    assert len(compiled.made) == 2 and len(nms._graphs) == 2
    _equal(out, want)
    nms.batched_nms(p, **args)
    assert len(compiled.made) == 2 and compiled.made[0].replays == 3


def test_the_cache_keeps_the_most_recent_keys(compiled):
    """``NMS_GRAPHS`` graphs at most: a new key past the bound drops the
    least recently used one, and a replay makes its key the most recent."""
    p = torch.from_numpy(_preds(2))
    thresholds = [0.3 + 0.01 * i for i in range(nms.NMS_GRAPHS)]
    for c in thresholds:
        nms.batched_nms(p, c, 0.45, 40)
    assert len(nms._graphs) == nms.NMS_GRAPHS
    nms.batched_nms(p, thresholds[0], 0.45, 40)       # a replay: now the most recent
    nms.batched_nms(p, 0.9, 0.45, 40)                  # drops thresholds[1]'s graph
    kept = {key[4] for key in nms._graphs}
    assert len(nms._graphs) == nms.NMS_GRAPHS and len(compiled.made) == nms.NMS_GRAPHS + 1
    assert thresholds[0] in kept and thresholds[1] not in kept and 0.9 in kept
    out = nms.batched_nms(p, thresholds[1], 0.45, 40)  # captured anew, equal to eager
    assert len(compiled.made) == nms.NMS_GRAPHS + 2
    _equal(out, nms.nms_core(p, thresholds[1], 0.45, 40))


def test_a_capture_inside_a_capture_raises():
    """One capture cannot hold another: a ``CapturedCall`` made during
    another's warm-up or capture on the same thread raises ``CaptureError``
    before it allocates or waits for the capture lock."""
    with capture._Recording([]):
        with pytest.raises(CaptureError, match="inside another"):
            CapturedCall(lambda x: x, torch.zeros(2))
    assert not capture._CAPTURE_LOCK.locked()


def test_the_detectors_capture_calls_the_eager_core(monkeypatch, tmp_path):
    """The Detector's captured request runs ``nms_core``, never the compiled
    ``batched_nms``: with the compiled route forced on the CPU and the real
    ``CapturedCall`` in ``ops/nms.py`` (which raises when made inside a
    capture), the request captures and replays, equal to ``infer_eager``,
    and no NMS graph is made."""
    CpuGraph.made = []
    monkeypatch.setattr(detect_api, "CapturedCall", CpuGraph)
    monkeypatch.setattr(nms, "_replays", lambda pred: True)
    cfg = yaml.safe_load(open("cfg/chip_tiny.yaml"))
    cfg.update(image_size=64, save_dir=str(tmp_path) + "/")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        det = Detector(TrainPlan(cfg), device="cpu", seed=0)
        x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
        key = (0.01, 0.45, 100)
        for _ in range(2):
            _equal(det._replay(x, *key), det.infer_eager(x, *key))
    finally:
        torch.set_num_threads(n)
    assert len(CpuGraph.made) == 1 and CpuGraph.made[0].replays == 2
    assert len(nms._graphs) == 0
