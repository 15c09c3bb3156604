"""PyTorch port vs JAX package: the rest of ``ops/enhance.py`` (the
perspective, the device letter box, the enhance ``random_hsv``,
``EnhancePackage``) and the perspective on the train path.

JAX's draws are replayed (``_torch_port.perspective_uniforms``,
``jax_batch_draw``) and fed to the port's apply step. The port composes the
perspective matrix in fp64 from JAX's fp32 uniforms, JAX in fp32: the
matrices agree to ~3e-6. Tolerances:

- warped images: atol 1e-2 on 0..255 (bilinear weights of source
  coordinates that differ by ~1e-5 px), under the precondition that no
  pixel's source coordinate (JAX's) lies within ``MARGIN`` px of the
  [-0.5, size - 0.5] bounds, where a pixel switches to the fill;
- boxes 1e-3 px, masks equal, under the precondition that no
  ``box_candidates`` quantity lies within ``MARGIN`` of its threshold;
- ``box_candidates``: exact; letter box images atol 1e-3 on 0..255 (the
  warp of ``test_torch_port_augment.py``), boxes exact; HSV atol 1e-3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_port_augment as A
from _torch_port import jax_batch_draw, perspective_uniforms
from yolo_continuous_tpu.ops import augment as J
from yolo_continuous_tpu.ops import enhance as JE
from yolo_continuous_tpu_torch.ops import augment as P
from yolo_continuous_tpu_torch.ops import enhance as PE

S = 64
MARGIN = 1e-4
IMG_TOL, BOX_TOL = 1e-2, 1e-3


def _images_and_boxes(B, h=S, w=S, seed=0, mb=6):
    rs = np.random.RandomState(seed)
    img = (rs.rand(B, h, w, 3) * 255).astype(np.float32)
    img[:, h // 3:, : w // 3] = 90.0                              # a flat patch
    boxes = np.zeros((B, mb, 5), np.float32)
    mask = np.zeros((B, mb), bool)
    for b in range(B):
        for i in range(rs.randint(2, mb)):
            bw, bh = rs.uniform(8, w / 2), rs.uniform(8, h / 2)
            x, y = rs.uniform(0, w - bw), rs.uniform(0, h - bh)
            boxes[b, i] = [x, y, x + bw, y + bh, rs.randint(3)]
            mask[b, i] = True
    return img, boxes, mask


def _source_margin(matrix, h, w):
    """The smallest distance of a pixel's source coordinate (from JAX's
    matrix) to the bounds where the warp switches to the fill."""
    inv = np.linalg.inv(np.asarray(matrix, np.float64))
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    src = np.einsum("ij,jhw->ihw", inv, np.stack([xx, yy, np.ones_like(xx)]))
    sx, sy = src[0] / src[2], src[1] / src[2]
    return min(np.abs(sx + 0.5).min(), np.abs(sx - (w - 0.5)).min(),
               np.abs(sy + 0.5).min(), np.abs(sy - (h - 0.5)).min())


def _candidate_margin(box1, box2, mask):
    """The smallest relative distance of a valid box's ``box_candidates``
    quantity from its threshold."""
    b1, b2 = np.asarray(box1, np.float64)[mask], np.asarray(box2, np.float64)[mask]
    w1, h1 = b1[:, 2] - b1[:, 0], b1[:, 3] - b1[:, 1]
    w2, h2 = b2[:, 2] - b2[:, 0], b2[:, 3] - b2[:, 1]
    area = w2 * h2 / (w1 * h1 + 1e-16)
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return min(np.abs(w2 - 2.0).min(), np.abs(h2 - 2.0).min(), np.abs(area - 0.1).min(),
               np.abs(ar - 20.0).min()) if len(b1) else np.inf


@pytest.mark.parametrize("perspective", [0.0, 1e-3])
def test_random_perspective_matches_jax(perspective):
    B = 4
    img, boxes, mask = _images_and_boxes(B, seed=1)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    jcfg = JE.PerspectiveCfg(perspective=perspective)
    want = [JE.random_perspective(k, jnp.asarray(i), jnp.asarray(b), jnp.asarray(m),
                                  perspective=perspective)
            for k, i, b, m in zip(keys, img, boxes, mask)]
    mats = [np.asarray(JE._perspective_matrix(jax.random.split(k)[0], S, S, jcfg)) for k in keys]
    vals = torch.tensor([perspective_uniforms(jax.random.split(k)[0], PE.PerspectiveCfg(*jcfg))
                         for k in keys])
    p = PE.perspective_from_uniforms(vals, S, S)
    np.testing.assert_allclose(p.matrix.numpy(), np.stack(mats), rtol=1e-5, atol=1e-4)
    got = PE.random_perspective(p, *map(torch.from_numpy, (img, boxes, mask)), perspective)
    w_img, w_bx, w_bm = (np.stack([np.asarray(w[i]) for w in want]) for i in range(3))
    assert min(_source_margin(m, S, S) for m in mats) > MARGIN, "precondition: a source on a bound"
    scale = np.sqrt(np.abs(np.linalg.det(np.stack(mats)[:, :2, :2])))[:, None, None]
    assert _candidate_margin(boxes[..., :4] * scale, w_bx[..., :4], mask) > MARGIN, \
        "precondition: a box on a box_candidates threshold"
    np.testing.assert_allclose(got[0].numpy(), w_img, rtol=0, atol=IMG_TOL)
    np.testing.assert_array_equal(got[2].numpy(), w_bm)
    assert w_bm.any() and not w_bm[mask].all() or w_bm.sum() > 4
    np.testing.assert_allclose(got[1].numpy() * w_bm[..., None], w_bx * w_bm[..., None],
                               rtol=0, atol=BOX_TOL)


def test_warp_fill_and_edges_match_map_coordinates():
    """Pixels whose source lies in [-0.5, 0) or (size - 1, size - 0.5] blend
    the edge pixel with the fill, as ``map_coordinates(mode="constant")``."""
    img = np.random.RandomState(3).rand(1, 16, 20, 3).astype(np.float32) * 255
    for tx, ty in ((-0.3, 0.2), (0.4, -0.45), (0.0, 0.0)):
        m = np.array([[1.0, 0.0, tx], [0.0, 1.0, ty], [0.0, 0.0, 1.0]], np.float32)
        want = JE._warp_image(jnp.asarray(img[0]), jnp.asarray(m))
        got = PE.warp_image(torch.from_numpy(img), torch.from_numpy(np.linalg.inv(m))[None])
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-3)


def test_box_candidates_is_exact():
    rs = np.random.RandomState(4)
    b1 = (rs.rand(3, 50, 4) * 40).astype(np.float32)
    b1[..., 2:] += b1[..., :2]
    b2 = b1 * rs.uniform(0.05, 1.5, (3, 50, 1)).astype(np.float32)
    b2[:, :5, 2] = b2[:, :5, 0] + 2.0                          # on the width threshold
    b2[:, 5:10, 3] = b2[:, 5:10, 1] + 0.01                     # a sliver: the aspect limit
    want = np.asarray(JE.box_candidates(jnp.asarray(b1), jnp.asarray(b2)))
    got = PE.box_candidates(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("stretch", [True, False])
def test_letter_box_matches_jax(stretch):
    img, boxes, mask = _images_and_boxes(2, h=40, w=72, seed=5)
    want = [JE.letter_box(jax.random.PRNGKey(0), jnp.asarray(i), jnp.asarray(b), jnp.asarray(m),
                          S, scale_fill_prob=1.0 if stretch else 0.0)
            for i, b, m in zip(img, boxes, mask)]
    got = PE.letter_box(torch.full((2,), stretch), *map(torch.from_numpy, (img, boxes, mask)), S)
    w_img, w_bx, w_bm = (np.stack([np.asarray(w[i]) for w in want]) for i in range(3))
    np.testing.assert_allclose(got[0].numpy(), w_img, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[1].numpy(), w_bx)
    np.testing.assert_array_equal(got[2].numpy(), w_bm)
    if not stretch:                                   # the pad rows keep the fill
        np.testing.assert_allclose(got[0][:, :4].numpy(), 114.0, atol=1e-3)


def test_enhance_random_hsv_matches_jax():
    img, boxes, mask = _images_and_boxes(3, seed=6)
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    gains = (0.015, 0.7, 0.4)
    want = [np.asarray(JE.random_hsv(k, jnp.asarray(i), None, None, *gains)[0])
            for k, i in zip(keys, img)]
    u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (3,), jnp.float32, -1.0, 1.0))
                                   for k in keys]))
    got, bx, bm = PE.random_hsv(u, torch.from_numpy(img), torch.from_numpy(boxes),
                                torch.from_numpy(mask), *gains)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0, atol=1e-3)
    assert torch.equal(bx, torch.from_numpy(boxes)) and torch.equal(bm, torch.from_numpy(mask))


def _package_draw(keys, cfg: dict, h, w, use_perspective):
    """The draws of JAX ``EnhancePackage.__call__`` (``enhance.py:270-285``:
    ``split(key, 5)``) as the port's ``PackageDraw``."""
    lr, ud, eq, hsv, stretch, persp = [], [], [], [], [], []
    pcfg = PE.PerspectiveCfg(cfg.get("degrees", 10.0), cfg.get("translate", 0.1),
                             cfg.get("scale", 0.1), cfg.get("shear", 10.0),
                             cfg.get("perspective", 0.0))
    for k in keys:
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        eq.append(float(jax.random.uniform(k1)) < cfg.get("equalize", 0.0))
        hsv.append(np.asarray(jax.random.uniform(k2, (3,), jnp.float32, -1.0, 1.0)))
        f1, f2 = jax.random.split(k3)
        lr.append(float(jax.random.uniform(f1)) < cfg.get("flip_lr", 0.5))
        ud.append(float(jax.random.uniform(f2)) < cfg.get("flip_ud", 0.5))
        persp.append(perspective_uniforms(jax.random.split(k4)[0], pcfg))
        stretch.append(float(jax.random.uniform(k5)) < cfg.get("scale_fill", 1.0))
    p = PE.perspective_from_uniforms(torch.tensor(persp), h, w) if use_perspective else None
    return PE.PackageDraw(PE.EnhanceDraw(torch.tensor(lr), torch.tensor(ud), torch.tensor(eq), p),
                          torch.from_numpy(np.stack(hsv)), torch.tensor(stretch))


@pytest.mark.parametrize("use_perspective", [False, True])
def test_enhance_package_matches_jax(use_perspective):
    cfg = dict(equalize=0.5, flip_lr=0.5, flip_ud=0.5, scale_fill=0.5, hsv_h=0.015, hsv_s=0.7,
               hsv_v=0.4, degrees=10.0, translate=0.1, scale=0.1, shear=10.0)
    img, boxes, mask = _images_and_boxes(4, h=48, w=56, seed=8)
    img = np.round(img)                                       # equalize rounds its input
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    jpkg = JE.EnhancePackage(S, cfg, use_perspective=use_perspective)
    want = [jpkg(k, jnp.asarray(i), jnp.asarray(b), jnp.asarray(m))
            for k, i, b, m in zip(keys, img, boxes, mask)]
    draw = _package_draw(keys, cfg, 48, 56, use_perspective)
    assert draw.enhance.equalize.any() and draw.stretch.any() and not draw.stretch.all()
    got = PE.EnhancePackage(S, cfg, use_perspective)(draw, *map(torch.from_numpy,
                                                                (img, boxes, mask)))
    w_img, w_bx, w_bm = (np.stack([np.asarray(w[i]) for w in want]) for i in range(3))
    np.testing.assert_array_equal(got[2].numpy(), w_bm)
    np.testing.assert_allclose(got[0].numpy(), w_img, rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(got[1].numpy() * w_bm[..., None], w_bx * w_bm[..., None],
                               rtol=0, atol=BOX_TOL)


def test_enhance_package_draws_and_eval_mode():
    pkg = PE.EnhancePackage(S, {"scale_fill": 0.0}, use_perspective=True)
    a = pkg.draw(torch.Generator().manual_seed(1), 3, 40, 50)
    b = pkg.draw(torch.Generator().manual_seed(1), 3, 40, 50).to("cpu")
    for x, y in zip(P._leaves(a), P._leaves(b)):
        assert torch.equal(x, y) and x.dtype == y.dtype
    assert a.enhance.perspective.matrix.shape == (3, 3, 3) and not a.stretch.any()
    img, boxes, mask = _images_and_boxes(3, h=40, w=50, seed=10)
    out, bx, bm = pkg(a, *map(torch.from_numpy, (img, boxes, mask)), enhance=False)
    want = PE.letter_box(a.stretch, *map(torch.from_numpy, (img, boxes, mask)), S)
    assert torch.equal(out, want[0]) and torch.equal(bx, want[1]) and out.shape == (3, S, S, 3)


@pytest.mark.parametrize("T,mosaic,mixup", [(1, [False] * 4, [True, False, True, False]),
                                            (4, [True, False, True, True], [True, True, False, False])])
def test_augment_batch_with_perspective_matches_jax(T, mosaic, mixup, monkeypatch):
    seen = [np.inf]
    candidates = PE.box_candidates

    def record(box1, box2, **kw):
        keep = candidates(box1, box2, **kw)
        valid = (box1[..., 2] > box1[..., 0])
        seen[0] = min(seen[0], _candidate_margin(box1.numpy(), box2.numpy(), valid.numpy()))
        return keep

    monkeypatch.setattr(PE, "box_candidates", record)
    tiles, metas, boxes, masks = A._inputs(4, T, seed=13)
    mosaic, mixup = np.array(mosaic), np.array(mixup)
    extra = dict(use_perspective=True, flip_ud=0.5)
    key = jax.random.PRNGKey(14)
    want = J.augment_batch(key, *map(jnp.asarray, (tiles, metas, boxes, masks, mosaic, mixup)),
                           cfg=J.AugConfig(size=S, **extra), max_gt=3 * A.MB, train=True)
    pcfg = P.AugConfig(size=S, **extra)
    draw = jax_batch_draw(key, pcfg, 4, T, A.MB, mosaic, mixup)
    mats = [m for d in (draw.partner, draw.post) for m in d.perspective.matrix.numpy()]
    assert min(_source_margin(m, S, S) for m in mats) > MARGIN, "precondition: a source on a bound"
    got = P.augment_batch(draw, *map(torch.from_numpy, (tiles, metas, boxes, masks)), cfg=pcfg,
                          max_gt=3 * A.MB, train=True)
    assert seen[0] > MARGIN, f"precondition: a box {seen[0]} from a box_candidates threshold"
    img, bx, bm = (np.asarray(t) for t in got)
    w_img, w_bx, w_bm = (np.asarray(t) for t in want)
    np.testing.assert_allclose(img, w_img, rtol=0, atol=IMG_TOL / 255.0 + A.IMG_TOL)
    np.testing.assert_array_equal(bm, w_bm)
    assert w_bm.any()
    np.testing.assert_allclose(bx * bm[..., None], w_bx * w_bm[..., None], rtol=0, atol=BOX_TOL)


def test_trainer_takes_use_perspective(tmp_path):
    """The plan key reaches the AugConfig, and a step's draws and augment
    run with it (the port's Trainer refused it before the perspective was
    ported)."""
    import _torch_port as TP
    from yolo_continuous_tpu_torch.config.plan import TrainPlan
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    ann = TP.write_dataset(tmp_path, 4, seed=1)
    cfg = dict(TP.tiny_plan_cfg("Detect", S), train=ann, val=ann, batch_size=2,
               use_perspective=True, save_dir=str(tmp_path) + "/")
    tr = Trainer(TrainPlan(cfg), device="cpu")
    assert tr.aug_cfg.use_perspective
    from yolo_continuous_tpu_torch.data.dataset import YoloDataset, load_annotation_file
    ds = YoloDataset(load_annotation_file(ann), S, tr.plan.max_boxes, train=True, seed=0)
    batch = next(ds.epoch_batches(2, False, True))
    draw = tr.draw(0, batch[0].shape[1], *batch[-2:])
    assert draw.post.perspective is not None and draw.partner.perspective is not None
    images, labels, lmask = tr.augment(draw, batch, True)
    assert images.shape == (2, S, S, 3) and torch.isfinite(images).all()
    assert ((labels[..., 1:] >= 0) & (labels[..., 1:] <= 1))[lmask].all()
