"""PyTorch port vs JAX package: degenerate inputs (``tests/test_robustness.py``).

The five cases of the JAX test file, each through the JAX function and the
port's on the same numpy inputs: saturated logits (|x| = 30), zero-size,
outside and oversized boxes, 32 identical boxes, a batch with no boxes, and
more matches than ``max_gt``. Each must stay finite in both, and the port
must give JAX's answer. Tolerances: the loss and its parts rtol 1e-5 with
``num_fg`` exact, gradients rtol 1e-4 and atol 1e-6 x max|g| (those of
``test_torch_port_loss.py``); NMS's keep-set exact; the augmented images
atol 2e-4 on 0..1 (those of ``test_torch_port_augment.py``), masks exact.
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_port import jax_batch_draw
from yolo_continuous_tpu.losses import yolo_loss as JL
from yolo_continuous_tpu.ops import augment as JA
from yolo_continuous_tpu.ops.nms import nms_single as jax_nms_single
from yolo_continuous_tpu_torch.losses import yolo_loss as PL
from yolo_continuous_tpu_torch.ops import augment as PA
from yolo_continuous_tpu_torch.ops.nms import nms_single

FLAT = [[12, 16], [19, 36], [40, 28], [36, 75], [76, 55], [72, 146],
        [142, 110], [192, 243], [459, 401]]
MASK = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
ANCHORS = tuple(tuple(tuple(float(v) for v in FLAT[j]) for j in m) for m in MASK)


def _cfgs(nc=2, max_gt=8):
    kw = dict(num_classes=nc, input_size=(64, 64), strides=(32, 16, 8), anchors=ANCHORS,
              max_gt=max_gt)
    return JL.LossConfig(**kw), PL.LossConfig(**kw)


def _preds(seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(1, s, s, 3, 7) * scale).astype(np.float32) for s in (2, 4, 8)]


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(jcfg):
    """JAX's loss, its parts and its gradients in one jitted call (one compile
    for every case: the op-by-op trace of the loss and its gradient takes
    half a minute)."""
    return jax.jit(jax.value_and_grad(lambda q, t, m: JL.yolo_loss(q, t, m, jcfg),
                                      has_aux=True))


def _losses_match(preds, targets, tmask, grads=False):
    """The JAX and port losses (and gradients) on the same inputs: finite and equal."""
    jcfg, pcfg = _cfgs()
    (jloss, jparts), want = _jax_loss_and_grad(jcfg)([jnp.asarray(p) for p in preds],
                                                     jnp.asarray(targets), jnp.asarray(tmask))
    ps = [torch.tensor(p, requires_grad=True) for p in preds]
    loss, parts = PL.yolo_loss(ps, torch.from_numpy(targets), torch.from_numpy(tmask), pcfg)
    assert np.isfinite(float(loss.detach())) and np.isfinite(float(jloss))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]), rtol=1e-5, atol=1e-7)
    assert int(parts["num_fg"]) == int(jparts["num_fg"])
    if grads:
        loss.backward()
        for p, w in zip(ps, want):
            w = np.asarray(w)
            assert torch.isfinite(p.grad).all() and np.isfinite(w).all()
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                       atol=1e-6 * float(np.abs(w).max()))
    return parts


def test_loss_extreme_logits_match_jax():
    """Saturated logits (|x| = 30): loss and gradients finite, and JAX's."""
    preds = [p * 30.0 for p in _preds()]
    targets = np.zeros((1, 8, 5), np.float32)
    targets[0, 0] = [0, .5, .5, .5, .5]
    tmask = np.zeros((1, 8), bool)
    tmask[0, 0] = True
    _losses_match(preds, targets, tmask, grads=True)


def test_loss_degenerate_boxes_match_jax():
    """Zero-size, centre outside and larger than the image."""
    targets = np.array([[[0, 0.5, 0.5, 0.0, 0.0], [1, 1.5, -0.5, 0.3, 0.3],
                         [0, 0.5, 0.5, 5.0, 5.0], [0, 0, 0, 0, 0]] + [[0] * 5] * 4], np.float32)
    tmask = np.zeros((1, 8), bool)
    tmask[0, :3] = True
    _losses_match(_preds(), targets, tmask, grads=True)


def test_nms_all_identical_boxes_matches_jax():
    """32 identical boxes of one class: exactly one survivor, JAX's."""
    n = 32
    pred = np.zeros((n, 7), np.float32)
    pred[:, :4] = [0.5, 0.5, 0.2, 0.2]
    pred[:, 4] = np.linspace(0.5, 0.9, n)
    pred[:, 5] = 1.0
    want = [np.asarray(t) for t in jax_nms_single(jnp.asarray(pred), 0.1, 0.5, 16)]
    got = [t.numpy() for t in nms_single(torch.from_numpy(pred), 0.1, 0.5, 16)]
    assert int(got[3].sum()) == int(want[3].sum()) == 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[want[3]], w[want[3]])
    np.testing.assert_array_equal(got[3], want[3])


def test_augment_no_boxes_matches_jax():
    """Images with no ground-truth box flow through the augmentation."""
    rs = np.random.RandomState(0)
    S, MB = 64, 4
    tiles = rs.randint(0, 255, (2, 4, S, S, 3)).astype(np.uint8)
    metas = np.tile(np.array([S, S, 1.0, 0.0, 0.0], np.float32), (2, 4, 1))
    boxes = np.zeros((2, 4, MB, 5), np.float32)
    masks = np.zeros((2, 4, MB), bool)
    mosaic, mixup = np.array([True, False]), np.array([True, False])
    key = jax.random.PRNGKey(0)
    want = JA.augment_batch(key, *map(jnp.asarray, (tiles, metas, boxes, masks, mosaic, mixup)),
                            cfg=JA.AugConfig(size=S), max_gt=MB, train=True)
    draw = jax_batch_draw(key, PA.AugConfig(size=S), 2, 4, MB, mosaic, mixup)
    got = PA.augment_batch(draw, *map(torch.from_numpy, (tiles, metas, boxes, masks)),
                           cfg=PA.AugConfig(size=S), max_gt=MB, train=True)
    assert torch.isfinite(got[0]).all() and not got[2].any() and not np.asarray(want[2]).any()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)


def test_loss_gt_overflow_capacity_matches_jax():
    """Eight dense boxes, all valid: capped, finite, JAX's num_fg."""
    rs = np.random.RandomState(3)
    t = np.zeros((1, 8, 5), np.float32)
    t[0, :, 0] = rs.randint(0, 2, 8)
    t[0, :, 1:3] = rs.rand(8, 2) * 0.8 + 0.1
    t[0, :, 3:5] = rs.rand(8, 2) * 0.3 + 0.05
    parts = _losses_match(_preds(), t, np.ones((1, 8), bool))
    assert float(parts["num_fg"]) > 0
