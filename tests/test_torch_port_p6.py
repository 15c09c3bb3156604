"""PyTorch port vs JAX package: the 4-level P6 family (tests/test_p6_model.py).

yolov7-p6-lite (ReOrg stem, DownC, IAuxDetect over P3-P6, strides 8-64)
on tests/test_p6_model.py's plan (cfg/chip_tiny.yaml with the P6 anchors
and mask, 2 classes, batch 2, max_boxes 8), 128 px, fp32, the same
``lively`` weights in both packages:

- the spec: the head, the strides, four anchor rows;
- the raw maps, all eight (four leads, four aux), within 1e-4 of JAX's;
- one ``Trainer.train_step`` against JAX's jitted ``train_step_fn``
  (the IAuxDetect aux loss at 4 levels, the stride-64 obj balance 0.1):
  loss parts rtol 1e-3 and ``num_fg`` exact, updates and momentum buffers
  within 3e-2 relative L2, tests/test_torch_port_train.py's yolov7-tiny
  tolerances;
- the Detector's decode plus NMS against JAX's Detector (valid exact, boxes
  and scores 1e-4, classes exact, as tests/test_torch_port_detector.py,
  with its head gain; the top-k precondition is that no two neighbouring
  scores lie within twice the largest score difference of the packages,
  as 1,020 candidates an image crowd the top 100 closer than its 1e-5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import lively, min_score_gap
from test_p6_model import P6_ANCHORS, _plan
from test_torch_port_train import _rel_l2
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu.ops.decode import decode_outputs as jax_decode_outputs
from yolo_continuous_tpu.train.ema import ema_init
from yolo_continuous_tpu.train.train_loop import Trainer as JaxTrainer
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.ops.decode import decode_outputs
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax
from yolo_continuous_tpu_torch.train.train_loop import Trainer

SIZE, CONF, IOU, MAX_DET = 128, 0.01, 0.45, 100
HEAD_GAIN = 16.0
HYPER = (0.01, 0.1, 0.937)
PARTS = ("loss", "box", "obj", "cls")


def _port_plan(size=SIZE):
    return TrainPlan(dict(_plan(size).cfg))


@pytest.fixture(scope="module")
def p6():
    """JAX's Trainer of the plan, lively weights and a batch (test_p6_model.py's
    images, two labels an image)."""
    jt = JaxTrainer(_plan(SIZE), dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k, x: jt.model.init(k, x, False), jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    rs = np.random.RandomState(1)
    params, stats = lively(shapes["params"], rs), lively(shapes["batch_stats"], rs)
    rs = np.random.RandomState(0)
    images = rs.rand(2, SIZE, SIZE, 3).astype(np.float32)
    labels = np.zeros((2, 8, 5), np.float32)
    labels[:, 0] = [0, 0.5, 0.5, 0.5, 0.5]
    labels[:, 1] = [1, 0.3, 0.35, 0.2, 0.25]
    lmask = np.zeros((2, 8), bool)
    lmask[:, :2] = True
    return jt, params, stats, (images, labels, lmask)


def test_p6_spec():
    tr = Trainer(_port_plan(), device="cpu")
    assert tr.spec.head_name == "IAuxDetect" and tr.spec.strides == (8, 16, 32, 64)
    assert len(tr.spec.anchors) == 4 and tr.nl == 4
    assert tr.spec.anchors[3] == tuple(map(tuple, np.reshape(P6_ANCHORS[3], (3, 2)).tolist()))


def test_p6_raw_maps_match_jax(p6):
    jt, params, stats, (images, _, _) = p6
    ref = jax.jit(jt.model.apply, static_argnums=2)({"params": params, "batch_stats": stats},
                                                     jnp.asarray(images), False)
    tr = Trainer(_port_plan(), device="cpu")
    model = tr.init_state(state_dict=state_dict_from_jax(tr.spec, params, stats))["model"].eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(images).permute(0, 3, 1, 2).contiguous())
    assert len(ours) == len(ref) == 8
    sides = [o.shape[1] for o in ours]
    assert sides == [16, 8, 4, 2] * 2
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-4)


def test_p6_train_step_matches_jax(p6):
    jt, params, stats, batch = p6
    st = {"params": params, "batch_stats": stats, "opt": jt.optimizer.init(params),
          "ema": ema_init({"params": params, "batch_stats": stats}),
          "step": jnp.zeros((), jnp.int32)}
    # JAX's own jitted step, the one tests/test_p6_model.py compiles for this plan
    new, metrics = jt.jitted_train_step()(st, *map(jnp.asarray, batch), *HYPER)
    tr = Trainer(_port_plan(), device="cpu")
    state = tr.init_state(state_dict=state_dict_from_jax(tr.spec, params, stats))
    old = {k: v.clone() for k, v in state["model"].state_dict().items()}
    state, parts = tr.train_step(state, *batch, *HYPER)
    assert int(parts["num_fg"]) == int(metrics["num_fg"]) > 0
    for k in PARTS:
        assert float(metrics[k]) > 0
        np.testing.assert_allclose(float(parts[k]), float(metrics[k]), rtol=1e-3, err_msg=k)
    names = [n for n, _ in state["model"].named_parameters()]
    want = state_dict_from_jax(tr.spec, new["params"], new["batch_stats"])
    got = state["model"].state_dict()
    assert _rel_l2({n: got[n] - old[n] for n in names},
                   {n: want[n] - old[n] for n in names}, names) <= 3e-2
    momentum = state_dict_from_jax(tr.spec, new["opt"].momentum_buf, {})
    bufs = {n: state["opt"].state[p]["momentum_buffer"]
            for n, p in state["model"].named_parameters()}
    assert _rel_l2(bufs, momentum, names) <= 3e-2


def test_p6_detector_matches_jax(p6):
    """The lead convs' kernels scaled by HEAD_GAIN spread the scores, as
    tests/test_torch_port_detector.py does (lively's give ties)."""
    _, params, stats, (images, _, _) = p6
    head = params["iauxdetect"]
    params = dict(params, iauxdetect={
        name: ({k: v * HEAD_GAIN if k == "kernel" else v for k, v in leaf.items()}
               if name.startswith("m") and not name.startswith("m2") else leaf)
        for name, leaf in head.items()})
    plan = _plan(SIZE)
    plan.save_path = "/nonexistent/x.msgpack"
    jdet = JaxDetector(plan, dtype=jnp.float32, params=params, batch_stats=stats)
    det = Detector(_port_plan(), device="cpu",
                   state_dict=state_dict_from_jax(jdet.spec, params, stats))
    with torch.no_grad():
        pred = decode_outputs(det.forward(images), det.spec.anchors, det.spec.strides).numpy()
    assert pred.shape[1] == 3 * (16 ** 2 + 8 ** 2 + 4 ** 2 + 2 ** 2)
    maps = jax.jit(jdet.model.apply, static_argnums=2)(
        {"params": jdet.params, "batch_stats": jdet.batch_stats}, jnp.asarray(images), False)
    ref_pred = np.asarray(jax_decode_outputs(maps[:4], jdet.spec.anchors, jdet.spec.strides))

    def score(p):
        return p[..., 4] * p[..., 5:].max(-1)
    # top-k ranks alike when no two neighbours lie within twice the largest
    # score difference of the packages
    drift = np.abs(score(pred) - score(ref_pred)).max()
    assert min_score_gap(np.where(score(pred) >= CONF, score(pred), -1.0), MAX_DET) > 2 * drift
    ours = [t.numpy() for t in det(images, CONF, IOU, MAX_DET)]
    ref = [np.asarray(t) for t in jdet(jnp.asarray(images), CONF, IOU, MAX_DET)]
    valid = ref[3]
    np.testing.assert_array_equal(ours[3], valid)
    assert 0 < valid.sum(1).min() and valid.sum(1).max() < MAX_DET
    np.testing.assert_allclose(ours[0][valid], ref[0][valid], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours[1][valid], ref[1][valid], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours[2][valid], ref[2][valid])
