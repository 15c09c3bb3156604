"""PyTorch port vs JAX package: box IoUs, focal losses, SimOTA and yolo_loss.

The same numpy-seeded inputs go through ``yolo_continuous_tpu`` (CPU, fp32)
and ``yolo_continuous_tpu_torch``. Tolerances: ``bbox_iou`` and the focal
losses rtol 1e-6 (values and gradients); SimOTA's ``fg`` and ``matched_gt``
exactly, under the stated preconditions (no top-20 IoU sum within 1e-4 of an
integer, neighbouring costs more than 1e-5 apart), as ``min_score_gap``
guards top-k ties elsewhere; ``yolo_loss`` parts rtol 1e-5 with ``num_fg``
exact; its gradients with respect to the head maps rtol 1e-4, atol 1e-6 x
max|g|. The head maps are those of yolov7-tiny at 64 px, batch 2
(2 x 2, 4 x 4 and 8 x 8 cells, 3 anchors), max_gt 8.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_continuous_tpu.losses import focal as jax_focal
from yolo_continuous_tpu.losses import yolo_loss as jax_loss
from yolo_continuous_tpu.ops import boxes as jax_boxes
from yolo_continuous_tpu_torch.losses import focal, yolo_loss
from yolo_continuous_tpu_torch.ops import boxes

NC, SIZE, BS, MAX_GT = 3, 64, 2, 8
ANCHORS = (((142.0, 110.0), (192.0, 243.0), (459.0, 401.0)),
           ((36.0, 75.0), (76.0, 55.0), (72.0, 146.0)),
           ((12.0, 16.0), (19.0, 36.0), (40.0, 28.0)))
STRIDES = (32, 16, 8)


def _cfgs(max_gt=MAX_GT, nc=NC, size=SIZE):
    kw = dict(num_classes=nc, input_size=(size, size), strides=STRIDES, anchors=ANCHORS,
              max_gt=max_gt)
    return jax_loss.LossConfig(**kw), yolo_loss.LossConfig(**kw)


def _maps(seed, nc=NC, size=SIZE):
    rs = np.random.RandomState(seed)
    return [(rs.randn(BS, size // s, size // s, 3, 5 + nc) * 2).astype(np.float32)
            for s in STRIDES]


def _labels(seed, max_gt=MAX_GT, counts=(3, 4), nc=NC):
    """``counts[b]`` boxes in image b, 15-50% of the image wide and high."""
    rs = np.random.RandomState(seed)
    labels = np.zeros((BS, max_gt, 5), np.float32)
    lmask = np.zeros((BS, max_gt), bool)
    for b, n in enumerate(counts):
        for g in range(n):
            labels[b, g] = [rs.randint(nc), rs.uniform(.25, .75), rs.uniform(.25, .75),
                            rs.uniform(.15, .5), rs.uniform(.15, .5)]
            lmask[b, g] = True
    return labels, lmask


def _pairs(seed, n=4000):
    rs = np.random.RandomState(seed)
    xy = rs.rand(2, n, 2) * 10
    wh = rs.rand(2, n, 2) * 5 + 0.1
    return np.concatenate([xy, wh], -1).astype(np.float32)       # xywh


# ---------------------------------------------------------------- boxes

@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
@pytest.mark.parametrize("xyxy", [True, False])
def test_bbox_iou_matches_jax(kind, xyxy):
    b = _pairs(0)
    if xyxy:
        b = np.concatenate([b[..., :2], b[..., :2] + b[..., 2:]], -1)
    kw = {kind: True} if kind != "iou" else {}
    want = np.asarray(jax_boxes.bbox_iou(jnp.asarray(b[0]), jnp.asarray(b[1]), xyxy, **kw))
    got = boxes.bbox_iou(torch.from_numpy(b[0]), torch.from_numpy(b[1]), xyxy, **kw).numpy()
    assert want.min() < 0.05 and want.max() > 0.5          # apart and overlapping pairs
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_ciou_gradient_matches_jax_with_alpha_held():
    """CIoU's alpha has no gradient in both (stop_gradient / detach)."""
    b = _pairs(1, 500)

    def jfn(p):
        return jnp.sum(jax_boxes.bbox_iou(p, jnp.asarray(b[1]), False, ciou=True))

    want = np.asarray(jax.grad(jfn)(jnp.asarray(b[0])))
    p = torch.from_numpy(b[0]).requires_grad_()
    boxes.bbox_iou(p, torch.from_numpy(b[1]), False, ciou=True).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_make_grid_matches_jax():
    np.testing.assert_array_equal(boxes.make_grid(5, 3).numpy(),
                                  np.asarray(jax_boxes.make_grid(5, 3)))


# ---------------------------------------------------------------- focal

@pytest.mark.parametrize("name", ["focal_loss", "qfocal_loss"])
def test_focal_losses_and_gradients_match_jax(name):
    rs = np.random.RandomState(2)
    pred = (rs.randn(4096) * 4).astype(np.float32)
    true = np.where(rs.rand(4096) < 0.3, rs.rand(4096), 0.0).astype(np.float32)
    true[:64] = 1.0
    jfn, pfn = getattr(jax_focal, name), getattr(focal, name)
    want = np.asarray(jfn(jnp.asarray(pred), jnp.asarray(true)))
    want_g = np.asarray(jax.grad(lambda p: jnp.sum(jfn(p, jnp.asarray(true))))(jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_()
    got = pfn(p, torch.from_numpy(true))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(p.grad.numpy(), want_g, rtol=1e-6, atol=1e-8)


def test_safe_pow_has_a_zero_gradient_at_zero():
    x = torch.tensor([0.0, 0.25], requires_grad=True)
    focal._safe_pow(x, 1.5).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad[0] == 0


# ---------------------------------------------------------------- SimOTA

def _match_inputs(seed):
    """The candidates of yolo_loss's first match (g = 0.5), built by both
    packages from the same maps and labels, with their decoded boxes."""
    labels, lmask = _labels(seed)
    maps = _maps(seed + 100)
    jcfg, _ = _cfgs()
    out = []
    for i, m in enumerate(maps):
        h, w = m.shape[1:3]
        anchors_f = np.asarray(ANCHORS[i], np.float32) / STRIDES[i]
        j = jax.vmap(lambda t, k: jax_loss._candidates_level(t, k, h, w, jnp.asarray(anchors_f),
                                                             4.0, 0.5))(labels, lmask)
        p = yolo_loss._candidates_level(torch.from_numpy(labels), torch.from_numpy(lmask), h, w,
                                        torch.from_numpy(anchors_f), 4.0, 0.5)
        out.append((m, anchors_f, [np.asarray(a) for a in j], [a.numpy() for a in p]))
    return labels, lmask, out


def test_candidates_match_jax():
    _, _, levels = _match_inputs(3)
    assert sum(int(p[4].sum()) for _, _, _, p in levels) > 10
    for _, _, j, p in levels:
        for a, b in zip(j, p):
            np.testing.assert_array_equal(b, a)


def _decode_candidates(levels, labels):
    """pbox (xyxy px), p_obj, p_cls and the mask of every candidate (numpy
    fp32, the formulas of yolo_loss.match_cands)."""
    sig = lambda v: 1.0 / (1.0 + np.exp(-v.astype(np.float64)))   # noqa: E731
    pbox, pobj, pcls, mask = [], [], [], []
    for (m, anchors_f, _, (gt, a, gi, gj, msk)), s in zip(levels, STRIDES):
        p = m[np.arange(BS)[:, None], gj, gi, a]
        pxy = (sig(p[..., :2]) * 2 - 0.5 + np.stack([gi, gj], -1)) * s
        pwh = (sig(p[..., 2:4]) * 2) ** 2 * anchors_f[a] * s
        pbox.append(np.concatenate([pxy - pwh / 2, pxy + pwh / 2], -1))
        pobj.append(p[..., 4])
        pcls.append(p[..., 5:])
        mask.append(msk)
    cat = lambda xs: np.concatenate(xs, 1).astype(np.float32)     # noqa: E731
    t = labels[..., 1:5] * SIZE
    tbox = np.concatenate([t[..., :2] - t[..., 2:] / 2, t[..., :2] + t[..., 2:] / 2], -1)
    return tbox.astype(np.float32), cat(pbox), cat(pobj), cat(pcls), np.concatenate(mask, 1)


def _match_preconditions(tbox, lmask, pbox, pobj, pcls, cmask):
    """fp64: the top-20 IoU sums are more than 1e-4 from an integer, and the
    valid costs of every gt row are more than 1e-5 apart, but for exact
    duplicates (one cell and anchor reached from two offsets: the same value
    in either package, ordered by the index tie-break)."""
    tb, pb = tbox.astype(np.float64), pbox.astype(np.float64)
    lt = np.maximum(tb[:, :, None, :2], pb[:, None, :, :2])
    rb = np.minimum(tb[:, :, None, 2:], pb[:, None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])   # noqa: E731
    iou = inter / (area(tb)[:, :, None] + area(pb)[:, None, :] - inter)
    pair = lmask[:, :, None] & cmask[:, None, :]
    iou = np.where(pair, iou, 0.0)
    s = -np.sort(-iou, -1)[..., :20].sum(-1)[lmask]
    frac = np.abs(s - np.round(s))
    y = np.sqrt(1 / (1 + np.exp(-pcls.astype(np.float64))) /
                (1 + np.exp(-pobj.astype(np.float64)))[..., None])
    logit = np.log(y / (1 - y))
    s0 = (np.clip(logit, 0, None) + np.log1p(np.exp(-np.abs(logit)))).sum(-1)
    cls = np.take_along_axis(logit.transpose(0, 2, 1), np.zeros_like(lmask, int)[..., None], 1)
    cost = s0[:, None, :] - cls + 3 * -np.log(iou + 1e-8)
    gaps = [np.diff(np.unique(cost[b, g][pair[b, g]])) for b, g in zip(*np.nonzero(lmask))]
    return float(frac.min()), float(min(gg.min() for gg in gaps if gg.size))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_simota_match_equals_jax_exactly(seed):
    labels, lmask, levels = _match_inputs(seed)
    labels[..., 0] = 0            # one class, so the precondition's cost is the match's
    tbox, pbox, pobj, pcls, cmask = _decode_candidates(levels, labels)
    frac, gap = _match_preconditions(tbox, lmask, pbox, pobj, pcls, cmask)
    assert frac > 1e-4 and gap > 1e-5, (frac, gap)
    tcls = labels[..., 0].astype(np.int32)
    jfg, jmg = jax.vmap(lambda *a: jax_loss._simota_match(*a, topk=20))(
        *map(jnp.asarray, (tbox, tcls, lmask, pbox, pobj, pcls, cmask)))
    pfg, pmg = yolo_loss._simota_match(*map(torch.from_numpy, (tbox, tcls, lmask, pbox, pobj,
                                                               pcls, cmask)), topk=20)
    jfg = np.asarray(jfg)
    assert jfg.sum() > 5
    np.testing.assert_array_equal(pfg.numpy(), jfg)
    np.testing.assert_array_equal(pmg.numpy()[jfg], np.asarray(jmg)[jfg])
    np.testing.assert_array_equal(pmg.numpy(), np.asarray(jmg))


# ---------------------------------------------------------------- yolo_loss

_JITTED = {}


def _jax_loss(max_gt, aux):
    key = (max_gt, aux)
    if key not in _JITTED:
        cfg, _ = _cfgs(max_gt)

        def fn(ps, t, m):
            lead, rest = list(ps[:3]), list(ps[3:])
            loss, parts = jax_loss.yolo_loss(lead, t, m, cfg, aux_preds=rest)
            return loss, parts

        _JITTED[key] = jax.jit(fn)
        _JITTED[key + ("grad",)] = jax.jit(jax.grad(lambda *a: fn(*a)[0]))
    return _JITTED[key], _JITTED[key + ("grad",)]


def _port_loss(maps, labels, lmask, max_gt, aux):
    _, cfg = _cfgs(max_gt)
    ps = [torch.from_numpy(m).requires_grad_() for m in maps]
    loss, parts = yolo_loss.yolo_loss(ps[:3], torch.from_numpy(labels), torch.from_numpy(lmask),
                                      cfg, aux_preds=ps[3:])
    loss.backward()
    return loss.detach(), parts, [p.grad.numpy() for p in ps]


CASES = {"lead": (False, (3, 4)), "aux": (True, (3, 4)), "empty_image": (False, (0, 5)),
         "empty_image_aux": (True, (5, 0))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_yolo_loss_parts_and_gradients_match_jax(case):
    aux, counts = CASES[case]
    maps = _maps(7) + (_maps(8) if aux else [])
    labels, lmask = _labels(9, counts=counts)
    loss_fn, grad_fn = _jax_loss(MAX_GT, aux)
    want, wparts = loss_fn(tuple(map(jnp.asarray, maps)), jnp.asarray(labels), jnp.asarray(lmask))
    wgrads = grad_fn(tuple(map(jnp.asarray, maps)), jnp.asarray(labels), jnp.asarray(lmask))
    got, parts, grads = _port_loss(maps, labels, lmask, MAX_GT, aux)
    assert int(parts["num_fg"]) == int(wparts["num_fg"]) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for k in ("box", "obj", "cls"):
        assert float(wparts[k]) > 0
        np.testing.assert_allclose(float(parts[k]), float(wparts[k]), rtol=1e-5, err_msg=k)
    for g, w in zip(grads, wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * np.abs(w).max())


def test_yolo_loss_with_no_ground_truth_keeps_only_obj():
    maps = _maps(10)
    labels, lmask = _labels(11)
    lmask[:] = False
    want, wparts = _jax_loss(MAX_GT, False)[0](tuple(map(jnp.asarray, maps)),
                                               jnp.asarray(labels), jnp.asarray(lmask))
    got, parts, _ = _port_loss(maps, labels, lmask, MAX_GT, False)
    assert float(parts["box"]) == float(parts["cls"]) == 0.0 and int(parts["num_fg"]) == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(got) > 0


@pytest.mark.parametrize("aux", [False, True])
def test_yolo_loss_is_invariant_to_padding(aux):
    """Growing the static GT capacity (8 -> 16) changes nothing, as in
    tests/test_loss.py::test_padding_invariance; and equals JAX at 16."""
    maps = _maps(12) + (_maps(13) if aux else [])
    l8, m8 = _labels(14)
    l16 = np.zeros((BS, 16, 5), np.float32)
    m16 = np.zeros((BS, 16), bool)
    l16[:, :MAX_GT], m16[:, :MAX_GT] = l8, m8
    a, pa, _ = _port_loss(maps, l8, m8, MAX_GT, aux)
    b, pb, _ = _port_loss(maps, l16, m16, 16, aux)
    assert abs(float(a) - float(b)) < 1e-6 and int(pa["num_fg"]) == int(pb["num_fg"])
    want, _ = _jax_loss(16, aux)[0](tuple(map(jnp.asarray, maps)), jnp.asarray(l16),
                                    jnp.asarray(m16))
    np.testing.assert_allclose(float(b), float(want), rtol=1e-5)


def test_yolo_loss_matches_the_torch_reference_golden():
    """The fixture of tests/test_loss.py (20 classes, 640 px), whose total the
    torch reference computed once: 3.3405237."""
    import test_loss
    preds, targets, tmask = test_loss._fixture()
    cfg = yolo_loss.LossConfig(num_classes=test_loss.NC, input_size=(640, 640),
                               strides=(32, 16, 8), anchors=test_loss.ANCHORS, max_gt=16)
    loss, parts = yolo_loss.yolo_loss([torch.tensor(np.asarray(p)) for p in preds],
                                      torch.tensor(np.asarray(targets)),
                                      torch.tensor(np.asarray(tmask)), cfg)
    golden = test_loss.REFERENCE_GOLDEN
    assert abs(float(loss) - golden) / golden < 1e-4 and int(parts["num_fg"]) > 0


def test_scatter_max_keeps_the_largest_obj_target():
    """Two candidates on one cell: tobj takes the larger IoU (a scatter-max,
    deterministic), whatever their order."""
    t = torch.zeros(4)
    t.scatter_reduce_(0, torch.tensor([1, 1, 2]), torch.tensor([0.25, 0.75, -1.0]), "amax")
    assert t.tolist() == [0.0, 0.75, 0.0, 0.0]
