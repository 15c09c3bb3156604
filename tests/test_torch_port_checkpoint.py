"""Checkpoints: the JAX package's msgpack read without flax, the port's own
train checkpoint, and the Detector's choice of weights (ROADMAP Queue 3,
fault 1: a plan whose ``save_path`` holds only a JAX checkpoint must serve
those weights, not a silent random init).

The JAX checkpoint is written by the JAX ``train/checkpoint.save_checkpoint``
from a full JAX train state of ``cfg/chip_tiny.yaml`` (yolov7-tiny, one
class) at 96 px, with lively weights whose EMA tree is another draw than the
raw ones. Detections are compared as tests/test_torch_port_detector.py does:
``valid`` exactly, boxes and scores within 1e-4, under the top-k score-gap
precondition.
"""
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization

from _torch_port import lively, min_score_gap
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu.train import checkpoint as jax_ckpt
from yolo_continuous_tpu.train.ema import ema_init
from yolo_continuous_tpu.train.train_loop import Trainer as JaxTrainer
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.ops.decode import decode_outputs
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax
from yolo_continuous_tpu_torch.train.checkpoint import (jax_weights, read_jax_msgpack,
                                                        save_checkpoint, train_checkpoint_path)
from yolo_continuous_tpu_torch.train.train_loop import Trainer

SIZE, CONF, IOU, MAX_DET, HEAD_GAIN = 96, 0.01, 0.45, 100, 16.0


def _cfg(tmp_dir):
    cfg = yaml.safe_load(open("cfg/chip_tiny.yaml"))
    cfg.update(image_size=SIZE, save_dir=str(tmp_dir) + "/", max_boxes=8)
    return cfg


def _draw(tree_p, tree_s, seed):
    rs = np.random.RandomState(seed)
    params, stats = lively(tree_p, rs), lively(tree_s, rs)
    params["detect"] = {name: {k: v * HEAD_GAIN if k == "kernel" else v for k, v in conv.items()}
                        for name, conv in params["detect"].items()}
    return params, stats


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX train state saved at the plan's save_path: raw weights of seed 3,
    an EMA tree of seed 6 (both meet the score-gap precondition), momentum
    buffers, step 7."""
    cfg = _cfg(tmp_path_factory.mktemp("runs"))
    jt = JaxTrainer(JaxPlan(dict(cfg)), dtype=jnp.float32)
    st = jt.init_state(jax.random.PRNGKey(0))
    params, stats = _draw(st["params"], st["batch_stats"], 3)
    ema_p, ema_s = _draw(st["params"], st["batch_stats"], 6)
    rs = np.random.RandomState(5)
    opt = jt.optimizer.init(params)
    opt = opt._replace(momentum_buf=jax.tree.map(
        lambda p: rs.randn(*np.shape(p)).astype(np.float32), opt.momentum_buf))
    ema = ema_init({"params": ema_p, "batch_stats": ema_s})._replace(updates=jnp.int32(7))
    state = dict(st, params=params, batch_stats=stats, opt=opt, ema=ema, step=jnp.int32(7))
    plan = JaxPlan(dict(cfg))
    jax_ckpt.save_checkpoint(plan.save_path, state)
    return dict(cfg=cfg, path=plan.save_path, state=state, spec=jt.spec)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def test_read_jax_msgpack_equals_flax(jax_run):
    """Every leaf of the JAX checkpoint, read with msgpack alone, equals what
    flax restores: params, batch_stats, the optimizer's momentum buffers, the
    EMA (a NamedTuple: a dict of its fields) and the step scalar."""
    with open(jax_run["path"], "rb") as f:
        want = dict(_flat(serialization.msgpack_restore(f.read())))
    got = dict(_flat(read_jax_msgpack(jax_run["path"])))
    assert set(got) == set(want)
    assert ("ema", "updates") in got and ("opt", "momentum_buf", "detect", "head_p3", "kernel") in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    assert int(got[("step",)]) == 7


def test_read_jax_msgpack_numpy_scalars(tmp_path):
    """numpy scalars arrive as ExtType 3 and come back as numpy scalars."""
    tree = {"s": np.float32(1.5), "i": np.int32(-3), "a": np.arange(6, dtype=np.int32)}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    got = read_jax_msgpack(str(path))
    assert got["s"] == np.float32(1.5) and got["s"].dtype == np.float32 and got["i"] == -3
    np.testing.assert_array_equal(got["a"], tree["a"])


@pytest.mark.parametrize("use_ema", [True, False])
def test_detector_serves_the_jax_checkpoint_at_save_path(jax_run, use_ema):
    """Fault 1: only the JAX .msgpack exists at save_path. The port's Detector
    gives the JAX Detector's detections, from the EMA tree by default and
    from the raw weights with use_ema=False."""
    jax_det = JaxDetector(JaxPlan(dict(jax_run["cfg"])), dtype=jnp.float32, use_ema=use_ema)
    det = Detector(TrainPlan(dict(jax_run["cfg"])), device="cpu", use_ema=use_ema)
    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    with torch.no_grad():
        pred = decode_outputs(det.forward(x), det.spec.anchors, det.spec.strides)
    score = (pred[..., 4] * pred[..., 5:].max(-1).values).numpy()
    assert min_score_gap(np.where(score >= CONF, score, -1.0), MAX_DET) > 1e-5
    ours = [t.numpy() for t in det(x, CONF, IOU, MAX_DET)]
    ref = [np.asarray(t) for t in jax_det(jnp.asarray(x), CONF, IOU, MAX_DET)]
    valid = ref[3]
    np.testing.assert_array_equal(ours[3], valid)
    assert valid.sum() > 0
    np.testing.assert_allclose(ours[0][valid], ref[0][valid], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours[1][valid], ref[1][valid], rtol=0, atol=1e-4)
    tree = jax_run["state"]["ema"].tree if use_ema else jax_run["state"]
    want = state_dict_from_jax(det.spec, tree["params"], tree["batch_stats"])
    for k, v in want.items():
        assert torch.equal(det.model.state_dict()[k], v), k


def test_the_weights_are_chosen_in_order(jax_run, tmp_path):
    """state_dict, then a .pth, then the port's train checkpoint, then the JAX
    .msgpack; the EMA of a train checkpoint unless use_ema=False."""
    cfg = dict(jax_run["cfg"], save_dir=str(tmp_path) + "/")
    plan = TrainPlan(dict(cfg))
    os.link(jax_run["path"], plan.save_path)
    spec = jax_run["spec"]
    ema = jax_run["state"]["ema"].tree
    from_jax = state_dict_from_jax(spec, ema["params"], ema["batch_stats"])
    w = "model.0.conv.weight"
    assert torch.equal(Detector(plan, device="cpu").model.state_dict()[w], from_jax[w])

    tr = Trainer(TrainPlan(dict(cfg)), device="cpu")
    state = tr.init_state(seed=11)
    state, _ = tr.train_step(state, np.random.RandomState(0).rand(1, SIZE, SIZE, 3),
                             np.array([[[0, 0.5, 0.5, 0.3, 0.3]] + [[0] * 5] * 7], np.float32),
                             np.array([[True] + [False] * 7]), 0.01, 0.1, 0.937)
    save_checkpoint(train_checkpoint_path(plan.save_path), state)
    assert train_checkpoint_path(plan.save_path) == str(tmp_path / "chip-tiny.train.pt")
    ema_w, raw_w = state["ema"].tree[w], state["model"].state_dict()[w]
    assert not torch.equal(ema_w, raw_w)
    assert torch.equal(Detector(plan, device="cpu").model.state_dict()[w], ema_w)
    assert torch.equal(Detector(plan, device="cpu", use_ema=False).model.state_dict()[w], raw_w)

    torch.save(from_jax, os.path.splitext(plan.save_path)[0] + ".pth")
    assert torch.equal(Detector(plan, device="cpu").model.state_dict()[w], from_jax[w])
    given = {k: v + 1 if v.is_floating_point() else v for k, v in from_jax.items()}
    assert torch.equal(Detector(plan, device="cpu", state_dict=given).model.state_dict()[w],
                       given[w])


def test_warm_start_from_a_jax_checkpoint(jax_run):
    """Trainer.warm_start on the JAX .msgpack loads the EMA tree, the weights
    that JAX's own warm_start loads; the optimizer and the EMA start fresh."""
    tr = Trainer(TrainPlan(dict(jax_run["cfg"])), device="cpu")
    logs = []
    state = tr.warm_start(jax_run["path"], tr.init_state(seed=0), log=logs.append)
    jt = JaxTrainer(JaxPlan(dict(jax_run["cfg"])), dtype=jnp.float32)
    jstate = jt.warm_start(jax_run["path"], jt.init_state(jax.random.PRNGKey(0)), log=logs.append)
    want = state_dict_from_jax(tr.spec, jstate["params"], jstate["batch_stats"])
    got = state["model"].state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert state["step"] == 0 and state["ema"].updates == 0 and not state["opt"].state
    assert all(torch.equal(state["ema"].tree[k], got[k]) for k in state["ema"].tree)
    assert len(logs) == 2 and jax_run["path"] in logs[0]


def test_jax_weights_picks_the_tree():
    ckpt = {"params": {"a": 1}, "batch_stats": {"b": 2},
            "ema": {"tree": {"params": {"a": 3}, "batch_stats": {"b": 4}}, "updates": 5}}
    assert jax_weights(ckpt) == ({"a": 3}, {"b": 4})
    assert jax_weights(ckpt, use_ema=False) == ({"a": 1}, {"b": 2})
