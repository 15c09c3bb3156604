"""PyTorch port vs JAX package: the device augmentation (``ops/augment.py``,
the ported part of ``ops/enhance.py``).

JAX draws its parameters from PRNG keys, the port from a ``torch.Generator``;
the key stream cannot be reproduced, so ``_torch_port.jax_batch_draw``
replays JAX's key splits in JAX and hands the values to the port's apply
step. Inputs are staged canvases of random images (``stage_image``), 64 px,
batches of 3-4, max_boxes 8. Tolerances:

- ``warp_canvas`` against ``jax.image.scale_and_translate``: atol 1e-3 on
  0..255 (sums of up to 64 products in another order);
- HSV: atol 1e-3 on 0..255; ``equalize`` and ``random_flip``: exact;
- images of the whole pipeline: atol 2e-4 on 0..1; boxes and labels: 1e-3
  px; masks equal, under the precondition that no box quantity that a mask
  is decided on (a width or height against 1 px, a coordinate against a
  mosaic cut line) lies within ``MARGIN`` of its threshold: XLA contracts
  ``a * b + c`` into one fused multiply-add and torch on the CPU does not,
  so coordinates differ in their last bits;
- eval mode: exact; pool mode: equal to the host-assembled batch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import jax_batch_draw
from yolo_continuous_tpu.ops import augment as J
from yolo_continuous_tpu.ops import enhance as JE
from yolo_continuous_tpu.ops.preprocess import stage_image
from yolo_continuous_tpu_torch.ops import augment as P
from yolo_continuous_tpu_torch.ops import enhance as PE

pytest.importorskip("cv2")
S, MB = 64, 8
MARGIN = 1e-4
IMG_TOL, BOX_TOL = 2e-4, 1e-3


def _inputs(B, T, seed=0):
    """Staged canvases (B,T,S,S,3) u8 of random images of mixed shapes, their
    metas, 0-6 boxes each in original px, masks."""
    rs = np.random.RandomState(seed)
    tiles = np.zeros((B, T, S, S, 3), np.uint8)
    metas = np.zeros((B, T, 5), np.float32)
    boxes = np.zeros((B, T, MB, 5), np.float32)
    masks = np.zeros((B, T, MB), bool)
    for b in range(B):
        for t in range(T):
            ih, iw = rs.randint(30, 100), rs.randint(30, 100)
            img = rs.randint(0, 255, (ih, iw, 3), np.uint8)
            img[ih // 3:, : iw // 3] = rs.randint(0, 255, 3)      # flat patches, HSV ties
            img[: ih // 4, iw // 2:] = rs.randint(0, 255)
            tiles[b, t], m = stage_image(img, S)
            metas[b, t] = [m.iw, m.ih, m.scale, m.ox, m.oy]
            for i in range(rs.randint(0, 7)):
                bw, bh = rs.uniform(6, iw / 2), rs.uniform(6, ih / 2)
                x, y = rs.uniform(0, iw - bw), rs.uniform(0, ih - bh)
                boxes[b, t, i] = [x, y, x + bw, y + bh, rs.randint(3)]
                masks[b, t, i] = True
    return tiles, metas, boxes, masks


@pytest.fixture
def margin(monkeypatch):
    """Records the smallest distance of a mask-deciding box quantity from its
    threshold inside the port's calls."""
    seen = [np.inf]
    transform, merge = P._transform_boxes, P._merge_mosaic_boxes

    def record(values, mask):
        if mask.any():
            seen[0] = min(seen[0], float(values[mask].abs().min()))

    def _transform(boxes, mask, *a):
        nb, ok = transform(boxes, mask, *a)
        m = mask[..., None].expand(-1, -1, 2)
        record(torch.stack([nb[..., 2] - nb[..., 0], nb[..., 3] - nb[..., 1]], -1) - 1.0, m)
        return nb, ok

    def _merge(q, boxes, mask, cutx, cuty):
        cuts = torch.stack([cutx, cuty, cutx, cuty], -1)[:, None]
        record(boxes[..., :4] - cuts, mask[..., None].expand(-1, -1, 4))
        return merge(q, boxes, mask, cutx, cuty)

    monkeypatch.setattr(P, "_transform_boxes", _transform)
    monkeypatch.setattr(P, "_merge_mosaic_boxes", _merge)
    return seen


def _check(got, want, margin_seen):
    img, bx, bm = (np.asarray(t) for t in got)
    w_img, w_bx, w_bm = (np.asarray(t) for t in want)
    np.testing.assert_allclose(img, w_img, rtol=0, atol=IMG_TOL)
    assert margin_seen[0] > MARGIN, f"precondition: a box quantity {margin_seen[0]} from a threshold"
    np.testing.assert_array_equal(bm, w_bm)
    np.testing.assert_allclose(bx * bm[..., None], w_bx * w_bm[..., None], rtol=0, atol=BOX_TOL)


@pytest.mark.parametrize("ky,kx,ty,tx", [(1.3, 0.7, 3.25, -5.5), (0.31, 0.5, 10.1, 2.7),
                                         (2.2, 1.9, -20.3, -7.7), (1.0, 1.0, 0.5, -0.25),
                                         (0.45, 3.1, 40.6, -60.2)])
def test_warp_canvas_matches_scale_and_translate(ky, kx, ty, tx):
    rs = np.random.RandomState(0)
    img = (rs.rand(3, 48, 56, 3) * 255).astype(np.float32)
    want = [np.asarray(jax.image.scale_and_translate(
        jnp.asarray(i) - 128.0, (S, S, 3), (0, 1), jnp.array([ky, kx], jnp.float32),
        jnp.array([ty, tx], jnp.float32), method="linear", antialias=True) + 128.0) for i in img]
    full = [torch.full((3,), v) for v in (ky, kx, ty, tx)]
    got = P.warp_canvas(torch.from_numpy(img), *full, S)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0, atol=1e-3)


def _hsv_image(rs):
    img = (rs.rand(2, 16, 16, 3) * 255).astype(np.float32)
    img[:, :4] = 128.0                                   # gray: diff 0
    img[:, 4:6, :, 1] = img[:, 4:6, :, 0]                # r == g
    img[:, 6:8, :, 2] = img[:, 6:8, :, 1]                # g == b
    img[:, 8:9] = 0.0                                    # black: mx 0
    return img


def test_hsv_matches_jax():
    rs = np.random.RandomState(1)
    img = _hsv_image(rs)
    hsv = np.asarray(J.rgb_to_hsv_cv(jnp.asarray(img)))
    np.testing.assert_allclose(P.rgb_to_hsv_cv(torch.from_numpy(img)).numpy(), hsv, atol=1e-3)
    np.testing.assert_allclose(P.hsv_to_rgb_cv(torch.from_numpy(hsv.copy())).numpy(),
                               np.asarray(J.hsv_to_rgb_cv(jnp.asarray(hsv))), atol=1e-3)
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    want = [np.asarray(J.random_hsv(k, jnp.asarray(i), 0.1, 0.7, 0.4)) for k, i in zip(keys, img)]
    u = torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k, (3,), jnp.float32, -1.0, 1.0))
                                   for k in keys]))
    got = P.random_hsv(u, torch.from_numpy(img), 0.1, 0.7, 0.4)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0, atol=1e-3)


def test_equalize_matches_jax_exactly():
    rs = np.random.RandomState(2)
    img = np.stack([
        rs.randint(0, 256, (24, 20, 3)).astype(np.float32),     # integers
        (rs.rand(24, 20, 3) * 300 - 20).astype(np.float32),     # rounding and clipping
        np.full((24, 20, 3), 77.0, np.float32),                 # one value: step 0, identity
        np.where(rs.rand(24, 20, 3) < 0.5, 3.0, 250.5).astype(np.float32),   # two values
    ])
    img[0, ..., 1] = np.round(img[0, ..., 1]) + 0.5             # halves: round to even
    want = np.stack([np.asarray(JE.equalize(jnp.asarray(i))) for i in img])
    np.testing.assert_array_equal(PE.equalize(torch.from_numpy(img)).numpy(), want)
    do = torch.tensor([True, False, True, False])
    got, _, _ = PE.random_equalize(do, torch.from_numpy(img), None, None)
    np.testing.assert_array_equal(got.numpy(), np.where(do.numpy()[:, None, None, None], want, img))


def test_random_flip_matches_jax_exactly():
    tiles, metas, boxes, masks = _inputs(4, 1, seed=3)
    img = tiles[:, 0].astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    want = [JE.random_flip(k, jnp.asarray(i), jnp.asarray(b), jnp.asarray(m), 0.5, 0.5)
            for k, i, b, m in zip(keys, img, boxes[:, 0], masks[:, 0])]
    draws = []
    for k in keys:
        k1, k2 = jax.random.split(k)
        draws.append([float(jax.random.uniform(k1)) < 0.5, float(jax.random.uniform(k2)) < 0.5])
    lr, ud = torch.tensor(draws).T
    assert lr.any() and ud.any() and not (lr & ud).all()
    got = PE.random_flip(PE.EnhanceDraw(lr, ud, torch.zeros(4, dtype=torch.bool)),
                         torch.from_numpy(img), torch.from_numpy(boxes[:, 0]),
                         torch.from_numpy(masks[:, 0]))
    for g, w in zip(got, zip(*want)):
        np.testing.assert_array_equal(g.numpy(), np.stack([np.asarray(x) for x in w]))


def _per_sample_keys(key, B, which):
    return [jax.random.split(k, 4)[which] for k in jax.random.split(key, B)]


def test_augment_single_matches_jax(margin):
    tiles, metas, boxes, masks = _inputs(4, 1, seed=5)
    cfg = J.AugConfig(size=S)
    key = jax.random.PRNGKey(6)
    want = [J.augment_single(k, jnp.asarray(tiles[b, 0], jnp.float32), jnp.asarray(metas[b, 0]),
                             jnp.asarray(boxes[b, 0]), jnp.asarray(masks[b, 0]), cfg)
            for b, k in enumerate(_per_sample_keys(key, 4, 1))]
    draw = jax_batch_draw(key, P.AugConfig(size=S), 4, 1, MB, np.zeros(4, bool), np.zeros(4, bool))
    got = P.augment_single(draw.single, torch.from_numpy(tiles[:, 0]).float(),
                           torch.from_numpy(metas[:, 0]), torch.from_numpy(boxes[:, 0]),
                           torch.from_numpy(masks[:, 0]), P.AugConfig(size=S))
    want = [np.stack([np.asarray(x) for x in w]) for w in zip(*want)]
    _check((got[0] / 255.0, got[1], got[2]), (want[0] / 255.0, want[1], want[2]), margin)


def test_augment_mosaic_matches_jax(margin):
    tiles, metas, boxes, masks = _inputs(3, 4, seed=7)
    cfg = J.AugConfig(size=S)
    key = jax.random.PRNGKey(8)
    want = [J.augment_mosaic(k, jnp.asarray(tiles[b], jnp.float32), jnp.asarray(metas[b]),
                             jnp.asarray(boxes[b]), jnp.asarray(masks[b]), cfg)
            for b, k in enumerate(_per_sample_keys(key, 3, 0))]
    draw = jax_batch_draw(key, P.AugConfig(size=S), 3, 4, MB, np.ones(3, bool), np.zeros(3, bool))
    got = P.augment_mosaic(draw.mosaic, torch.from_numpy(tiles).float(), torch.from_numpy(metas),
                           torch.from_numpy(boxes), torch.from_numpy(masks), P.AugConfig(size=S))
    want = [np.stack([np.asarray(x) for x in w]) for w in zip(*want)]
    _check((got[0] / 255.0, got[1], got[2]), (want[0] / 255.0, want[1], want[2]), margin)


BATCH_CASES = {
    "single": (1, {}, [False] * 4, [False] * 4),
    "mosaic_mixup": (4, {}, [True, False, True, True], [True, True, False, True]),
    "mosaic_paste_flip_ud": (4, dict(copy_paste=0.5, flip_ud=0.5),
                             [False, True, True, False], [True, False, True, False]),
    "single_paste_flip_ud": (1, dict(copy_paste=0.7, flip_ud=0.5, flip_lr=0.3),
                             [False] * 4, [False] * 4),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_augment_batch_matches_jax(case, margin):
    T, extra, mosaic, mixup = BATCH_CASES[case]
    tiles, metas, boxes, masks = _inputs(4, T, seed=9)
    mosaic, mixup = np.array(mosaic), np.array(mixup)
    jcfg = J.AugConfig(size=S, **extra)
    pcfg = P.AugConfig(size=S, **extra)
    key = jax.random.PRNGKey(10)
    want = J.augment_batch(key, *map(jnp.asarray, (tiles, metas, boxes, masks, mosaic, mixup)),
                           cfg=jcfg, max_gt=3 * MB, train=True)
    draw = jax_batch_draw(key, pcfg, 4, T, MB, mosaic, mixup)
    got = P.augment_batch(draw, *map(torch.from_numpy, (tiles, metas, boxes, masks)), cfg=pcfg,
                          max_gt=3 * MB, train=True)
    assert np.asarray(want[2]).any()
    _check(got, want, margin)


def test_eval_mode_is_exact():
    tiles, metas, boxes, masks = _inputs(3, 1, seed=11)
    flags = np.zeros(3, bool)
    want = J.augment_batch(jax.random.PRNGKey(0), *map(jnp.asarray, (tiles, metas, boxes, masks,
                                                                      flags, flags)),
                           cfg=J.AugConfig(size=S), max_gt=MB, train=False)
    got = P.augment_batch(None, *map(torch.from_numpy, (tiles, metas, boxes, masks)),
                          cfg=P.AugConfig(size=S), max_gt=MB, train=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pool_mode_equals_host_assembled():
    pool = _inputs(6, 1, seed=12)
    pool = tuple(a[:, 0] for a in pool)
    tile_idx = np.array([[0, 3, 5, 1], [2, 2, 2, 2], [4, 0, 1, 5]], np.int32)
    mosaic, mixup = np.array([True, False, True]), np.array([True, True, False])
    cfg = P.AugConfig(size=S, copy_paste=0.5)
    draw = P.draw_batch(torch.Generator().manual_seed(0), cfg, 3, 4, MB, mosaic, mixup)
    got = P.augment_batch_from_pool(draw, *map(torch.from_numpy, pool), torch.from_numpy(tile_idx),
                                    cfg=cfg, max_gt=2 * MB)
    host = P.augment_batch(draw, *(torch.from_numpy(a[tile_idx]) for a in pool), cfg=cfg,
                           max_gt=2 * MB)
    for g, h in zip(got, host):
        assert torch.equal(g, h)


def test_draws_are_reproducible_and_reach_the_device_whole():
    cfg = P.AugConfig(size=S, flip_ud=0.5, copy_paste=0.3)
    mosaic, mixup = np.array([1, 0, 1, 1, 0], bool), np.array([0, 1, 1, 0, 1], bool)
    a = P.draw_batch(torch.Generator().manual_seed(3), cfg, 5, 4, MB, mosaic, mixup)
    b = P.draw_batch(torch.Generator().manual_seed(3), cfg, 5, 4, MB, mosaic, mixup)
    moved = a.to("cpu")
    for x, y, z in zip(P._leaves(a), P._leaves(b), P._leaves(moved)):
        assert torch.equal(x, y) and torch.equal(x, z) and x.dtype == z.dtype
    assert a.paste.shape == (5, 8 * MB) and a.mosaic.ar.shape == (3, 4, 2)
    assert a.mosaic_idx.tolist() == [0, 2, 3] and a.mixup.tolist() == mixup.tolist()
    # the flagged samples' rows of the draws every sample takes
    full = P.draw_batch(torch.Generator().manual_seed(3), cfg, 5, 4, MB, np.ones(5, bool), mixup)
    for x, y in zip(a.mosaic, full.mosaic):
        assert torch.equal(x, y[[0, 2, 3]])
    one = P.draw_batch(torch.Generator(), cfg, 5, 1, MB, mosaic, mixup)
    assert one.mosaic is None and one.mosaic_idx is None
    lo, hi = cfg.mosaic_scale_min, cfg.mosaic_scale_max
    assert ((a.mosaic.scale >= lo) & (a.mosaic.scale < hi)).all()


def test_cap_boxes_keeps_the_first_valid_in_order():
    rs = np.random.RandomState(13)
    boxes = rs.rand(3, 20, 5).astype(np.float32)
    mask = rs.rand(3, 20) < 0.4
    want = [J._cap_boxes(jnp.asarray(b), jnp.asarray(m), 6) for b, m in zip(boxes, mask)]
    got = P._cap_boxes(torch.from_numpy(boxes), torch.from_numpy(mask), 6)
    for g, w in zip(got, zip(*want)):
        np.testing.assert_array_equal(g.numpy(), np.stack([np.asarray(x) for x in w]))


def test_perspective_and_the_rest_of_enhance_raise():
    """The perspective, ``EnhancePackage`` and the device ``letter_box`` run
    and raise nothing: ``_post_enhance`` applies the perspective first (its
    parity with JAX is ``test_torch_port_enhance.py``'s)."""
    tiles, metas, boxes, masks = _inputs(2, 1, seed=14)
    img = torch.from_numpy(tiles[:, 0]).float()
    bx, bm = torch.from_numpy(boxes[:, 0]), torch.from_numpy(masks[:, 0])
    cfg = P.AugConfig(size=S, use_perspective=True)
    draw = P.draw_post_enhance(torch.Generator().manual_seed(0), cfg, 2)
    got = P._post_enhance(draw, img, bx, bm, cfg)
    want = PE.random_perspective(draw.perspective, img, bx, bm)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    pkg = PE.EnhancePackage(S, {})
    out = pkg(pkg.draw(torch.Generator(), 2, S, S), img, bx, bm)
    assert out[0].shape == (2, S, S, 3)
    out = PE.letter_box(torch.tensor([True, False]), img, bx, bm, 32)
    assert out[0].shape == (2, 32, 32, 3)
