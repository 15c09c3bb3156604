"""PyTorch port NMS (plain version of kernels K1/K2) vs the JAX package.

Keep-sets must be exactly equal to the JAX sequential greedy oracle, its
fixpoint form, the Pallas K1 kernel and the Pallas K2 kernel (both in
interpret mode), at K = 31, 32, 33 (around one 32-row chunk of K1), 300
and 1024 (K1's range) and K = 1500 (K2's range).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import infer_inputs, min_score_gap
from yolo_continuous_tpu.kernels.nms_pallas import pallas_suppress, pallas_suppress_tiled
from yolo_continuous_tpu.ops import nms as jax_nms
from yolo_continuous_tpu.ops.boxes import box_iou as jax_box_iou
from yolo_continuous_tpu_torch.kernels import nms as k1k2
from yolo_continuous_tpu_torch.kernels.nms import (K2_MAX, cluster_size, k1_smem_bytes, k2_ring,
                                                   k2_sweep_smem, mask_words,
                                                    nms_suppress, nms_suppress_tiled, tiled_scratch)
from yolo_continuous_tpu_torch.ops import nms
from yolo_continuous_tpu_torch.ops.boxes import box_iou


def _case(seed, n, nc=3):
    """Score-sorted random boxes, as tests/test_nms_pallas.py builds them."""
    rs = np.random.RandomState(seed)
    cxy = rs.rand(n, 2)
    wh = rs.rand(n, 2) * 0.3 + 0.02
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    order = np.argsort(-rs.rand(n))
    return boxes[order], rs.randint(0, nc, n)[order].astype(np.int32), np.ones(n, bool)


def _chain(n, step=5.0):
    """Each box overlaps the next (IoU 1/3 at step 5): greedy keeps every other."""
    x = np.arange(n, dtype=np.float32) * step
    boxes = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], -1).astype(np.float32)
    return boxes, np.zeros(n, np.int32), np.ones(n, bool)


def _port_keep_sets(boxes, classes, valid, thr):
    b, c, v = torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(valid)
    iou = box_iou(b, b)
    same = c[:, None] == c[None, :]
    return {"fixpoint": nms._fixpoint_suppress(iou, same, v, thr),
            "greedy": nms._greedy_suppress(iou, same, v, thr),
            "suppress": nms.suppress(b[None], c[None], v[None], thr)[0]}


def _jax_keep_sets(boxes, classes, valid, thr):
    b, c, v = jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid)
    same = c[:, None] == c[None, :]
    iou = jax_box_iou(b, b)
    return {"jax_greedy": jax_nms._greedy_suppress(iou, same, v, thr),
            "jax_fixpoint": jax_nms._fixpoint_suppress(iou, same, v, thr),
            "pallas_k1": pallas_suppress(b, c, v, thr, interpret=True),
            "pallas_k2": pallas_suppress_tiled(b, c, v, thr, interpret=True)}


@pytest.mark.parametrize("case", ["random", "chain"])
@pytest.mark.parametrize("k", [31, 32, 33, 300, 1024, 1500])
def test_keep_sets_equal_jax_and_pallas(k, case):
    boxes, classes, valid = _case(k, k) if case == "random" else _chain(k)
    # a few random boxes seldom overlap by half: 0.3 there, as in the chain
    thr = 0.5 if case == "random" and k >= 300 else 0.3
    ref = {n: np.asarray(v) for n, v in _jax_keep_sets(boxes, classes, valid, thr).items()}
    want = ref["jax_greedy"]
    assert 0 < want.sum() < k                            # suppression did real work
    if case == "chain":
        np.testing.assert_array_equal(want, np.arange(k) % 2 == 0)
    for name, keep in {**ref, **_port_keep_sets(boxes, classes, valid, thr)}.items():
        np.testing.assert_array_equal(np.asarray(keep), want, err_msg=name)


@pytest.mark.parametrize("seed", range(6))
def test_fixpoint_equals_greedy(seed):
    boxes, classes, valid = _case(100 + seed, 200)
    valid[::7] = False
    keeps = _port_keep_sets(boxes, classes, valid, 0.45)
    assert torch.equal(keeps["fixpoint"], keeps["greedy"])
    assert torch.equal(keeps["suppress"], keeps["greedy"])


def _preds(seed, bs=2, n=3000, nc=4):
    """Random rows whose scores are spread at least 1/n apart: obj is a
    permutation of a grid and one class column per row is exactly 1."""
    rs = np.random.RandomState(seed)
    p = rs.rand(bs, n, 5 + nc).astype(np.float32)
    p[..., 2:4] = p[..., 2:4] * 0.2 + 0.02
    p[..., 4] = np.stack([rs.permutation(n) for _ in range(bs)]) / n + 0.5 / n
    p[..., 5:] *= 0.9
    p[np.arange(bs)[:, None], np.arange(n)[None], 5 + rs.randint(0, nc, (bs, n))] = 1.0
    return p


@pytest.mark.parametrize("per_class", [True, False])
@pytest.mark.parametrize("max_det", [300, 1500])
def test_batched_nms_matches_jax(max_det, per_class):
    """Score, threshold, top-k, xywh->xyxy and suppression together; both
    sides take the kernel dispatch of their own CPU path."""
    p = _preds(max_det + per_class)
    score = p[..., 4] * p[..., 5:].max(-1)
    assert min_score_gap(np.where(score >= 0.3, score, -1.0), max_det) > 1e-5   # no top-k ties
    ours = [t.numpy() for t in nms.batched_nms(torch.from_numpy(p), 0.3, 0.45, max_det,
                                               per_class)]
    ref = [np.asarray(t) for t in jax_nms.batched_nms(jnp.asarray(p), 0.3, 0.45, max_det,
                                                      per_class)]
    keep = ref[3]
    np.testing.assert_array_equal(ours[3], keep)
    assert 0 < keep.sum() < keep.size
    np.testing.assert_allclose(ours[0][keep], ref[0][keep], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours[1][keep], ref[1][keep])
    np.testing.assert_array_equal(ours[2][keep], ref[2][keep])


def test_nms_single_matches_jax():
    p = _preds(7, bs=1, n=800)[0]
    ours = nms.nms_single(torch.from_numpy(p), 0.2, 0.45, 1000)
    ref = jax_nms.nms_single(jnp.asarray(p), 0.2, 0.45, 1000)
    assert ours[0].shape == (1000, 4)                     # padded to max_det
    keep = np.asarray(ref[3])
    np.testing.assert_array_equal(ours[3].numpy(), keep)
    np.testing.assert_allclose(ours[0].numpy()[keep], np.asarray(ref[0])[keep], atol=1e-6)


def test_nms_single_matches_jax_exactly():
    """A full 640 px plan's candidates (25,200 x 85, 80 classes) to 300 kept:
    the keep-set, its order and every output equal JAX's."""
    p = infer_inputs(2, 64)[2][0]
    ours = nms.nms_single(torch.from_numpy(p), 0.25, 0.45, 300)
    ref = jax_nms.nms_single(jnp.asarray(p), 0.25, 0.45, 300)
    score = p[:, 4] * p[:, 5:].max(-1)
    assert min_score_gap(np.where(score >= 0.25, score, -1.0)[None], 300) > 0   # no tied rank
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(ref[3]))         # keep-set, in order
    assert int(ours[3].sum()) > 0     # (random boxes of 80 classes: the top 300 rarely overlap)
    for o, r in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_yolo_correct_boxes_match_jax():
    rs = np.random.RandomState(3)
    xy = rs.rand(2, 5, 2).astype(np.float32) * 0.6
    b = np.concatenate([xy, xy + 0.3], -1)
    shapes = np.array([[480, 640], [720, 405]], np.float32)
    for letterbox in (True, False):
        ref = np.asarray(jax_nms.yolo_correct_boxes(jnp.asarray(b[0]), (640, 640),
                                                    (480, 640), letterbox))
        ours = nms.yolo_correct_boxes(torch.from_numpy(b[0]), (640, 640), (480, 640), letterbox)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(
            nms.yolo_correct_boxes_np(b, (640, 640), shapes, letterbox),
            jax_nms.yolo_correct_boxes_np(b, (640, 640), shapes, letterbox), rtol=0, atol=0)


@pytest.mark.parametrize("kernel", [nms_suppress, nms_suppress_tiled])
def test_nms_kernels_take_cuda_tensors_only(kernel):
    boxes, classes, valid = (torch.from_numpy(a)[None] for a in _case(0, 16))
    with pytest.raises(ValueError, match="CUDA"):
        kernel(boxes, classes, valid, 0.5)
    assert kernel.launches == 0


@pytest.mark.parametrize("k", [1, 31, 32, 33, 1025, 1500, 4096, 8192, 25200, K2_MAX])
def test_k2_mask_rows_cover_k_columns_in_16_byte_words(k):
    words = mask_words(k)
    assert words % 4 == 0 and 32 * words >= k and 32 * (words - 4) < k


def test_k2_scratch_is_one_mask_row_per_candidate():
    boxes = torch.zeros(3, 1500, 4)
    scratch = tiled_scratch(boxes)
    assert scratch.shape == (3, 1500, 48) and scratch.dtype == torch.int32
    assert tiled_scratch(torch.zeros(16, 4096, 4)).numel() * 4 == 32 << 20    # 32 MB


def test_k1_constants_are_the_kernels():
    """K1_MAX, K1_MAX_CLUSTER, K1_KEEP_WORDS, K1_TILE_STRIDE and
    SMEM_PER_BLOCK copy kK1MaxK, kMaxCluster, kKeepWords, kTileStride and
    kSmemPerBlock of csrc/nms.cu; k1_smem_bytes copies its k1_smem_bytes,
    which fits a CTA at K1_MAX."""
    src = (pathlib.Path(k1k2.__file__).parent.parent / "csrc" / "nms.cu").read_text()

    def const(name):
        return eval(re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1))

    names = ("kK1MaxK", "kMaxCluster", "kKeepWords", "kTileStride", "kSmemPerBlock")
    assert tuple(const(n) for n in names) == (k1k2.K1_MAX, k1k2.K1_MAX_CLUSTER, k1k2.K1_KEEP_WORDS,
                                              k1k2.K1_TILE_STRIDE, k1k2.SMEM_PER_BLOCK)
    assert ("return static_cast<size_t>(k) * (16 + 4 + 4) + 4 * kKeepWords +\n"
            "         4 * kTileStride * static_cast<size_t>((k + 31) / 32) * ((k + 31) / 32);" in src)
    assert k1_smem_bytes(1024) == 1024 * 24 + 144 + 144 * 32 * 32 == 172176 <= k1k2.SMEM_PER_BLOCK
    assert k1_smem_bytes(300) == 300 * 24 + 144 + 144 * 10 * 10 == 21744


def test_cluster_size_halves_to_fit_the_sms_and_the_tiles():
    """8 CTAs an image while the batch's clusters fit on the SMs (132 on an
    H100 SXM, 114 on a PCIe card) and every CTA has a 32 x 32 tile of the
    upper triangle (ceil(K/32) (ceil(K/32) + 1) / 2 of them)."""
    assert [cluster_size(b, 300, 132) for b in (1, 16, 17, 33, 34, 66, 67)] == [8, 8, 4, 4, 2, 2, 1]
    assert cluster_size(16, 300, 114) == 4
    assert [cluster_size(1, k, 132) for k in (1, 32, 33, 64, 65, 96, 97, 1024)] == [1, 1, 2, 2, 4, 4, 8, 8]


def test_k2_ring_constants_are_the_kernels():
    """K2_MAX and K2_MAX_RING copy kTiledMaxK and kMaxRing of csrc/nms.cu;
    k2_sweep_smem copies its k2_sweep_smem. The ring holds 6 chunks up to
    K = 9600, 2 at a 640 px plan's 25,200 candidates, 2 at K2_MAX and none
    above."""
    src = (pathlib.Path(k1k2.__file__).parent.parent / "csrc" / "nms.cu").read_text()

    def const(name):
        return eval(re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1))

    assert (const("kTiledMaxK"), const("kMaxRing")) == (K2_MAX, k1k2.K2_MAX_RING) == (28544, 6)
    assert ("return static_cast<size_t>(ring) * 32 * mask_stride(k) * 4 + "
            "static_cast<size_t>(mask_stride(k)) * 4;" in src)
    assert [k2_ring(k) for k in (1025, 8192, 9600, 9601, 25200, K2_MAX, K2_MAX + 1)] == \
        [6, 6, 6, 5, 2, 2, 0]
    assert k2_sweep_smem(25200, 2) == 2 * 32 * 788 * 4 + 788 * 4 == 204880
    assert k2_sweep_smem(K2_MAX, 2) <= k1k2.SMEM_PER_BLOCK < k2_sweep_smem(K2_MAX + 1, 2)


def _epsilon_pair():
    """Two 6 px boxes at 640 px, 2.27585 px apart (ROADMAP Queue 3, fault 2):
    IoU just above 0.45 as ``inter / union``, just below it as
    ``inter / (union + 1e-9)``, the TPU kernels' denominator."""
    f = np.float32
    a = np.array([100.0, 300.0, 106.0, 306.0], f) / f(640)
    b = np.array([102.27585, 300.0, 108.27585, 306.0], f) / f(640)
    return np.stack([a, b]).astype(f), np.zeros(2, np.int32), np.ones(2, bool)


def test_iou_without_epsilon_follows_the_xla_route():
    """The port divides by the union as JAX's XLA route does (the oracle of
    the JAX tests), not by union + 1e-9 as the Pallas kernels do: on this
    pair, at thr 0.45, the port and ``_fixpoint_suppress`` suppress the second
    box and the Pallas kernels in interpret mode keep it."""
    boxes, classes, valid = _epsilon_pair()
    iou = box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes))[0, 1].item()
    inter = np.float32((boxes[0, 2] - boxes[1, 0]) * (boxes[0, 3] - boxes[0, 1]))
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    with_eps = inter / (area[0] + area[1] - inter + np.float32(1e-9))
    assert iou > 0.45 >= with_eps                                  # the pair straddles thr
    port = _port_keep_sets(boxes, classes, valid, 0.45)
    ref = _jax_keep_sets(boxes, classes, valid, 0.45)
    np.testing.assert_array_equal(np.asarray(ref["jax_fixpoint"]), [True, False])
    for name, keep in port.items():
        np.testing.assert_array_equal(keep.numpy(), [True, False], err_msg=name)
    for name in ("pallas_k1", "pallas_k2"):
        np.testing.assert_array_equal(np.asarray(ref[name]), [True, True], err_msg=name)
