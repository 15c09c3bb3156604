"""PyTorch port vs JAX package: RepConv fuse, the Detector's fuse, head_dtype,
reload_weights and predict(verbose=True) options.

After tests/test_fuse.py: ``fuse_repconv`` with and without the identity
branch gives the train form's outputs to atol 2e-4, and JAX's fused
weights; ``fuse_conv_bn`` JAX's. The Detectors run a small RepConv net (an
identity branch, a strided RepConv and a repeated one) at 96 px, batch 2,
fp32 body, from the same ``lively`` weights:

- ``Detector(fuse=True)``: its raw maps within 1e-4 of JAX's
  ``Detector(fuse=True)`` and its detections equal to JAX's (valid exact,
  boxes and scores 1e-4, classes exact, as tests/test_torch_port_detector.py);
  against the port's unfused Detector, maps and detections to
  tests/test_fuse.py's atol 2e-3;
- ``head_dtype=torch.bfloat16``: bf16 maps within one bf16 step of JAX's,
  the detections equal to JAX's with ``head_dtype=jnp.bfloat16`` as above;
- ``reload_weights`` with and without ``fuse``: the next call equals a fresh
  Detector on the same checkpoint bit for bit; False on a missing path;
- ``predict(verbose=True)`` prints JAX's table, GFLOPs included.
"""
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_port import FUSE_NET, lively, min_score_gap, tiny_plan_cfg
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu.detect_api import predict as jax_predict
from yolo_continuous_tpu.nn import fuse as jax_fuse
from yolo_continuous_tpu.nn.builder import YoloModel as JaxModel
from yolo_continuous_tpu.nn.builder import build_model_spec as jax_spec
from yolo_continuous_tpu.nn.layers import RepConv as JaxRepConv
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector, predict
from yolo_continuous_tpu_torch.nn import fuse
from yolo_continuous_tpu_torch.nn.layers import RepConv
from yolo_continuous_tpu_torch.ops.decode import decode_outputs
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax

SIZE, CONF, IOU, MAX_DET = 96, 0.01, 0.45, 100
WEIGHT_SEED, HEAD_GAIN = 3, 16.0


def _repconv_pair(c1, c2, seed=0):
    """A JAX RepConv's train-form variables (lively) and the port's train-form
    RepConv with the same weights."""
    m = JaxRepConv(c1, c2, 3, 1)
    x = np.random.RandomState(seed).randn(2, 8, 8, c1).astype(np.float32)
    v = jax.eval_shape(lambda k, a: m.init(k, a, False), jax.random.PRNGKey(0), jnp.asarray(x))
    rs = np.random.RandomState(seed + 1)
    params, stats = lively(v["params"], rs), lively(v["batch_stats"], rs)
    sd = state_dict_from_jax(None, {"l0_RepConv": params}, {"l0_RepConv": stats})
    port = RepConv(c1, c2).eval()
    port.load_state_dict({k[len("model.0."):]: t for k, t in sd.items()}, strict=True)
    return params, stats, port, x


@pytest.mark.parametrize("c1,c2", [(16, 16), (16, 32)], ids=["identity", "no-identity"])
def test_fuse_repconv_matches_train_form_and_jax(c1, c2):
    params, stats, port, x = _repconv_pair(c1, c2)
    assert (port.rbr_identity is not None) == (c1 == c2)
    fused = fuse.fuse_repconv(port.state_dict(), c1, c2)
    ref = jax_fuse.fuse_repconv(params, stats, c1, c2)["rbr_reparam"]
    np.testing.assert_allclose(fused["rbr_reparam.weight"].numpy(),
                               np.asarray(ref["kernel"]).transpose(3, 2, 0, 1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(fused["rbr_reparam.bias"].numpy(), np.asarray(ref["bias"]),
                               rtol=0, atol=1e-6)
    deploy = RepConv(c1, c2, deploy=True).eval()
    deploy.load_state_dict(fused, strict=True)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        np.testing.assert_allclose(deploy(xt).numpy(), port(xt).numpy(), rtol=0, atol=2e-4)


def test_fuse_conv_bn_matches_jax():
    rs = np.random.RandomState(0)
    k = rs.randn(3, 3, 4, 8).astype(np.float32)
    bn = {"scale": rs.rand(8).astype(np.float32) + 0.5, "bias": rs.randn(8).astype(np.float32),
          "mean": rs.randn(8).astype(np.float32), "var": rs.rand(8).astype(np.float32) + 0.1}
    kf, bf = jax_fuse.fuse_conv_bn(jnp.asarray(k), {n: jnp.asarray(v) for n, v in bn.items()})
    names = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    w, b = fuse.fuse_conv_bn(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                             {names[n]: torch.from_numpy(v) for n, v in bn.items()})
    np.testing.assert_array_equal(w.numpy(), np.asarray(kf).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(b.numpy(), np.asarray(bf))


def _cfg(tmp_dir):
    cfg = tiny_plan_cfg("Detect", SIZE)
    cfg.update(model_cfg=FUSE_NET, save_dir=str(tmp_dir) + "/", save_name="fuse")
    return cfg


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """lively JAX weights of FUSE_NET (a head gain spreads the scores) and the
    port's state dict of them."""
    cfg = _cfg(tmp_path_factory.mktemp("runs"))
    model = JaxModel(spec=jax_spec(FUSE_NET, 3, cfg["anchors"], 2))
    v = jax.eval_shape(lambda k, a: model.init(k, a, False), jax.random.PRNGKey(0),
                       jnp.zeros((1, SIZE, SIZE, 3)))
    rs = np.random.RandomState(WEIGHT_SEED)
    params, stats = lively(v["params"], rs), lively(v["batch_stats"], rs)
    params["detect"] = {name: {k: v * HEAD_GAIN if k == "kernel" else v for k, v in conv.items()}
                        for name, conv in params["detect"].items()}
    return cfg, params, stats, state_dict_from_jax(model.spec, params, stats)


X = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)


def _maps(det, head_dtype=torch.float32):
    maps = det.forward(X)
    assert all(m.dtype == head_dtype for m in maps)
    return [m.float().numpy() for m in maps]


def _jax_maps(jdet):
    apply = jax.jit(jdet.model.apply, static_argnums=2)
    return [np.asarray(m, np.float32) for m in apply(
        {"params": jdet.params, "batch_stats": jdet.batch_stats}, jnp.asarray(X), False)]


def _assert_detections_equal(ours, ref, atol):
    valid = np.asarray(ref[3])
    np.testing.assert_array_equal(ours[3].numpy(), valid)
    assert 0 < valid.sum(1).min() and valid.sum(1).max() < MAX_DET      # NMS dropped some
    np.testing.assert_allclose(ours[0].numpy()[valid], np.asarray(ref[0])[valid], rtol=0, atol=atol)
    np.testing.assert_allclose(ours[1].numpy()[valid], np.asarray(ref[1])[valid], rtol=0, atol=atol)
    np.testing.assert_array_equal(ours[2].numpy()[valid], np.asarray(ref[2])[valid])


def _no_ties(det):
    with torch.no_grad():
        pred = decode_outputs(det.forward(X), det.spec.anchors, det.spec.strides)
    score = (pred[..., 4] * pred[..., 5:].max(-1).values).numpy()
    return min_score_gap(np.where(score >= CONF, score, -1.0), MAX_DET)


def test_fused_detector_matches_jax_and_the_unfused_one(weights):
    cfg, params, stats, sd = weights
    plan = TrainPlan(dict(cfg))
    fused = Detector(plan, device="cpu", state_dict=sd, fuse=True)
    plain = Detector(plan, device="cpu", state_dict=sd)
    keys = fused.model.state_dict()
    assert not any("rbr_dense" in k or "rbr_1x1" in k or "rbr_identity" in k for k in keys)
    assert sum(".rbr_reparam.weight" in k for k in keys) == 5
    jdet = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32, params=params, batch_stats=stats,
                       fuse=True)
    assert _no_ties(fused) > 1e-5
    for o, r, p in zip(_maps(fused), _jax_maps(jdet), _maps(plain)):
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-4)
        np.testing.assert_allclose(o, p, rtol=0, atol=2e-3)
    ours = fused(X, CONF, IOU, MAX_DET)
    _assert_detections_equal(ours, jdet(jnp.asarray(X), CONF, IOU, MAX_DET), 1e-4)
    base = plain(X, CONF, IOU, MAX_DET)
    np.testing.assert_array_equal(ours[3].numpy(), base[3].numpy())
    np.testing.assert_allclose(ours[0].numpy(), base[0].numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(ours[1].numpy(), base[1].numpy(), rtol=0, atol=2e-3)


def test_bf16_head_matches_jax(weights):
    cfg, params, stats, sd = weights
    det = Detector(TrainPlan(dict(cfg)), device="cpu", state_dict=sd, head_dtype=torch.bfloat16)
    jdet = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32, params=params, batch_stats=stats,
                       head_dtype=jnp.bfloat16)
    for o, r in zip(_maps(det, torch.bfloat16), _jax_maps(jdet)):
        # one bf16 step: the fp32 sums round to bf16 from a different order
        np.testing.assert_allclose(o, r, rtol=2 ** -7, atol=1e-6)
    assert _no_ties(det) > 1e-5
    _assert_detections_equal(det(X, CONF, IOU, MAX_DET),
                             jdet(jnp.asarray(X), CONF, IOU, MAX_DET), 1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fuse"])
def test_reload_weights_serves_the_checkpoint(weights, tmp_path, fused):
    cfg, _, _, sd = weights
    cfg = dict(cfg, save_dir=str(tmp_path) + "/")
    plan = TrainPlan(dict(cfg))
    det = Detector(plan, device="cpu", seed=7, fuse=fused)
    before = [t.clone() for t in det(X, CONF, IOU, MAX_DET)]
    assert det.reload_weights() is False
    assert det.reload_weights(str(tmp_path / "missing.msgpack")) is False
    assert all(torch.equal(a, b) for a, b in zip(det(X, CONF, IOU, MAX_DET), before))
    torch.save(sd, os.path.splitext(plan.save_path)[0] + ".pth")
    assert det.reload_weights() is True
    fresh = Detector(TrainPlan(dict(cfg)), device="cpu", fuse=fused)
    for a, b in zip(det(X, CONF, IOU, MAX_DET), fresh(X, CONF, IOU, MAX_DET)):
        assert torch.equal(a, b)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(det.model.state_dict()[k], v), k


def test_predict_verbose_prints_jax_table(weights, tmp_path, capsys):
    cfg, params, stats, sd = weights
    path = tmp_path / "plan.yaml"
    path.write_text(yaml.safe_dump(dict(cfg)))
    det = Detector(TrainPlan(dict(cfg)), device="cpu", state_dict=sd, fuse=True)
    jdet = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32, params=params, batch_stats=stats,
                       fuse=True)

    def table(fn, d):
        fn(str(path), "resource/horses.jpg", 0.3, 0.3, detector=d, verbose=True)
        out = capsys.readouterr().out.splitlines()
        return out[: next(i for i, line in enumerate(out) if line.startswith("Model Summary")) + 1]

    ours = table(predict, det)
    assert ours == table(jax_predict, jdet)
    assert "GFLOPs @ 96px" in ours[-1] and "True]" in ours[2]       # the deploy flag
