"""PyTorch port vs JAX package: the mAP evaluator and dataset validation.

``eval/evaluator.py`` is a numpy copy: AP per class, mAP@0.5 and
mAP@0.5:0.95 equal to JAX's on random records. ``eval/validate.py`` against
JAX's ``validate`` for the same lively yolov7-tiny weights (64 px, fp32) on 4
images of mixed shapes, batch 3 (the second batch padded): the detections
handed to the evaluator (boxes in original pixels to 1e-3, scores to 1e-5,
classes equal) and the mAP summary (1e-6).
"""
import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from _torch_port import lively, write_dataset
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu.eval import evaluator as jev
from yolo_continuous_tpu.eval import validate as jval
from yolo_continuous_tpu_torch import val as val_cli
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.eval import evaluator as pev
from yolo_continuous_tpu_torch.eval import validate as pval
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax

pytest.importorskip("cv2")


def _records(rs, n_img=6, nc=3):
    out = []
    for _ in range(n_img):
        m, n = rs.randint(0, 6), rs.randint(0, 12)
        g = rs.rand(m, 2) * 80
        gt = np.concatenate([g, g + rs.rand(m, 2) * 40 + 5], 1).astype(np.float32)
        d = rs.rand(n, 2) * 80
        det = np.concatenate([d, d + rs.rand(n, 2) * 40 + 5], 1).astype(np.float32)
        if m and n:                                  # some detections near the truth
            k = min(m, n)
            det[:k] = gt[:k] + rs.randn(k, 4).astype(np.float32) * 3
        out.append((det, rs.rand(n).astype(np.float32), rs.randint(0, nc, n),
                    gt, rs.randint(0, nc, m)))
    return out


def test_map_evaluator_matches_jax():
    recs = _records(np.random.RandomState(0))
    evs = []
    for mod in (jev, pev):
        ev = mod.MAPEvaluator(3)
        for det, score, cls, gt, gcls in recs:
            ev.add(mod.DetectionRecord(det, score, cls), mod.GroundTruthRecord(gt, gcls))
        evs.append(ev)
    j, p = evs
    for thr in (0.5, 0.75):
        for eleven in (False, True):
            np.testing.assert_array_equal(p.ap_per_class(thr, eleven), j.ap_per_class(thr, eleven))
    assert p.summary() == j.summary() and 0 < p.map50() <= 1
    a, b = recs[0][0], recs[1][3]
    np.testing.assert_array_equal(pev._iou_matrix(a, b), jev._iou_matrix(a, b))


def _plan_cfg(ann, tmp_dir):
    cfg = yaml.safe_load(open("cfg/chip_tiny.yaml"))
    cfg.update(train=ann, val=ann, image_size=64, batch_size=3, labels=["a", "b"],
               save_dir=str(tmp_dir) + "/", save_name="v", max_boxes=8)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("val")
    cfg = _plan_cfg(write_dataset(root, 4, seed=1), root)
    jdet = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32)
    rs = np.random.RandomState(2)
    params, stats = lively(jdet.params, rs), lively(jdet.batch_stats, rs)
    jdet = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32, params=params, batch_stats=stats)
    det = Detector(TrainPlan(dict(cfg)), device="cpu",
                   state_dict=state_dict_from_jax(jdet.spec, params, stats))
    return cfg, jdet, det


def _recorded(mod, monkeypatch):
    seen = []
    add = mod.MAPEvaluator.add
    monkeypatch.setattr(mod.MAPEvaluator, "add",
                        lambda self, d, g: (seen.append((d, g)), add(self, d, g))[1])
    return seen


def test_validate_matches_jax(setup, monkeypatch):
    cfg, jdet, det = setup
    jseen, pseen = _recorded(jev, monkeypatch), _recorded(pev, monkeypatch)
    want = jval.validate(JaxPlan(dict(cfg)), detector=jdet, log=lambda *_: None)
    got = pval.validate(TrainPlan(dict(cfg)), detector=det, log=lambda *_: None)
    assert len(jseen) == len(pseen) == 4
    assert sum(len(d.scores) for d, _ in pseen) > 20
    for (jd, jg), (pd, pg) in zip(jseen, pseen):
        np.testing.assert_array_equal(pd.classes, jd.classes)
        np.testing.assert_allclose(pd.scores, jd.scores, rtol=0, atol=1e-5)
        np.testing.assert_allclose(pd.boxes, jd.boxes, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(pg.boxes, jg.boxes)
        np.testing.assert_array_equal(pg.classes, jg.classes)
    assert set(got) == {"mAP@0.5", "mAP@0.5:0.95"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9)


def test_val_cli_runs_on_the_cpu(setup, tmp_path):
    cfg = dict(setup[0])
    path = tmp_path / "plan.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = val_cli.main([str(path), "--device", "cpu", "--max-images", "2"])
    assert set(out) == {"mAP@0.5", "mAP@0.5:0.95"} and all(0 <= v <= 1 for v in out.values())
    out = val_cli.main([str(path), "--device", "cpu", "--max-images", "2", "--quantize",
                        "--calib-images", "2"])        # int8: calibrate, then validate
    assert set(out) == {"mAP@0.5", "mAP@0.5:0.95"} and all(0 <= v <= 1 for v in out.values())
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            val_cli.main([str(path)])
