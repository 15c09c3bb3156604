"""The whole slice: the port's Detector (CPU, fp32) against the JAX Detector.

``cfg/chip_tiny.yaml`` (yolov7-tiny, one class) at 96 px, batch 2, conf
0.01 so that NMS does real work. Both detectors carry the same weights:
the JAX tree, redrawn from a seed with a head gain that spreads the scores,
and bridged with ``state_dict_from_jax``. ``valid`` must be equal exactly;
boxes and scores within 1e-4; classes equal.
"""
import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from _torch_port import lively, min_score_gap
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu.detect_api import predict as jax_predict
from yolo_continuous_tpu_torch import detect as detect_cli
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector, predict
from yolo_continuous_tpu_torch.ops.decode import decode_outputs
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax

SIZE, CONF, IOU, MAX_DET = 96, 0.01, 0.45, 100
WEIGHT_SEED, HEAD_GAIN = 3, 16.0   # chosen so the top-k scores are 1e-5 apart


def _cfg(tmp_dir):
    cfg = yaml.safe_load(open("cfg/chip_tiny.yaml"))
    cfg.update(image_size=SIZE, save_dir=str(tmp_dir) + "/")
    return cfg


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = _cfg(tmp_path_factory.mktemp("runs"))
    jax_det = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32)
    rs = np.random.RandomState(WEIGHT_SEED)
    params = lively(jax_det.params, rs)
    stats = lively(jax_det.batch_stats, rs)
    params["detect"] = {name: {k: v * HEAD_GAIN if k == "kernel" else v for k, v in conv.items()}
                        for name, conv in params["detect"].items()}
    jax_det = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32, params=params,
                          batch_stats=stats)
    plan = TrainPlan(dict(cfg))
    sd = state_dict_from_jax(jax_det.spec, params, stats)
    return jax_det, Detector(plan, device="cpu", state_dict=sd), sd


def test_detector_matches_jax(pair):
    jax_det, det, _ = pair
    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    with torch.no_grad():
        pred = decode_outputs(det.forward(x), det.spec.anchors, det.spec.strides)
    score = (pred[..., 4] * pred[..., 5:].max(-1).values).numpy()
    assert min_score_gap(np.where(score >= CONF, score, -1.0), MAX_DET) > 1e-5  # no top-k ties

    ours = [t.numpy() for t in det(x, CONF, IOU, MAX_DET)]
    ref = [np.asarray(t) for t in jax_det(jnp.asarray(x), CONF, IOU, MAX_DET)]
    valid = ref[3]
    np.testing.assert_array_equal(ours[3], valid)
    assert 0 < valid.sum(1).min() and valid.sum(1).max() < MAX_DET   # NMS dropped some
    np.testing.assert_allclose(ours[0][valid], ref[0][valid], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours[1][valid], ref[1][valid], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours[2][valid], ref[2][valid])


def test_predict_matches_jax(pair, capsys, tmp_path):
    """letterbox -> detector -> un-letterbox -> TargetBox, on the stock image."""
    jax_det, det, _ = pair
    cfg = tmp_path / "plan.yaml"
    cfg.write_text(yaml.safe_dump(_cfg(tmp_path)))
    ours = predict(str(cfg), "resource/horses.jpg", 0.3, 0.3, detector=det)
    ref = jax_predict(str(cfg), "resource/horses.jpg", 0.3, 0.3, detector=jax_det)
    assert len(ours) == len(ref) > 0
    for o, r in zip(ours, ref):
        assert (o.left, o.top, o.right, o.bottom, o.label) == (r.left, r.top, r.right,
                                                                r.bottom, r.label)
        assert abs(o.score - r.score) < 1e-4
    assert "TargetBox" in capsys.readouterr().out


def test_detector_loads_pth_beside_save_path(pair, tmp_path):
    _, det, sd = pair
    plan = TrainPlan(_cfg(tmp_path))
    torch.save(sd, os.path.splitext(plan.save_path)[0] + ".pth")
    loaded = Detector(plan, device="cpu")
    for k, v in det.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[k], v), k


def test_detector_seeded_random_init(tmp_path):
    plan = TrainPlan(_cfg(tmp_path))
    a, b = Detector(plan, device="cpu", seed=5), Detector(plan, device="cpu", seed=5)
    c = Detector(plan, device="cpu", seed=6)
    w = "model.0.conv.weight"
    assert torch.equal(a.model.state_dict()[w], b.model.state_dict()[w])
    assert not torch.equal(a.model.state_dict()[w], c.model.state_dict()[w])
    assert a.dtype == torch.float32


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The default device is cuda, and with no CUDA device the entry points
    raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector(TrainPlan(_cfg(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detect_cli.main(["cfg/chip_tiny.yaml", "resource/horses.jpg"])


def test_detect_cli_on_cpu(capsys):
    boxes = detect_cli.main(["cfg/chip_tiny.yaml", "resource/horses.jpg", "--device", "cpu",
                             "--conf", "0.2"])
    assert isinstance(boxes, list)
    assert len(boxes) == capsys.readouterr().out.count("TargetBox")
