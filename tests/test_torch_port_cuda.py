"""Kernels K1-K5 and the JPEG stager on the card against their plain PyTorch versions.

These need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. Run them on
the GPU machine with:

    python -m pytest tests/test_torch_port_cuda.py -m cuda

They import only the port (no JAX), so they run where flax is absent.
``chip_smoke.py`` holds the same kernels to the same checks at the main
path's full shapes.
"""
import numpy as np
import pytest
import torch

from _torch_port import (ANCHORS as ANCHOR_ROWS, FUSE_NET, YOLOV7_640_FUSED_TAILS, ZOO_GROUPS,
                         ZOO_NETS, ibin_logits, min_bin_gap, spread_weights, tiny_plan_cfg,
                         write_dataset, write_staging_files, zoo_net)
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.kernels import bin_decode, decode
from yolo_continuous_tpu_torch.kernels.bin_decode import decode_outputs_bin_cuda
from yolo_continuous_tpu_torch.kernels.decode import decode_outputs_cuda
from yolo_continuous_tpu_torch.kernels.decode import form_for as decode_form_for
from yolo_continuous_tpu_torch.kernels.fused_conv import (form_for, fused_pointwise_conv_cuda,
                                                          fused_pointwise_conv_plain,
                                                          reciprocal_mismatches)
from yolo_continuous_tpu_torch.kernels import nms as nms_k1k2
from yolo_continuous_tpu_torch.kernels.nms import nms_suppress, nms_suppress_tiled
from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
from yolo_continuous_tpu_torch.nn.heads import head_view
from yolo_continuous_tpu_torch.nn.yolo_body import YoloBody
from yolo_continuous_tpu_torch.ops import augment as aug
from yolo_continuous_tpu_torch.ops.enhance import equalize
from yolo_continuous_tpu_torch.ops.decode import decode_level, decode_level_bin
from yolo_continuous_tpu_torch.ops.nms import suppress, suppress_plain
from yolo_continuous_tpu_torch.train.train_loop import Trainer

pytestmark = pytest.mark.cuda
ANCHORS = (((142.0, 110.0), (192.0, 243.0), (459.0, 401.0)),
           ((36.0, 75.0), (76.0, 55.0), (72.0, 146.0)),
           ((12.0, 16.0), (19.0, 36.0), (40.0, 28.0)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions keep fp32 products
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("normalized", [True, False])
def test_decode_kernel_matches_plain(cuda, normalized):
    g = torch.Generator(device=cuda).manual_seed(0)
    maps = [head_view(torch.randn(3, 3 * 9, n, n + 1, device=cuda, generator=g) * 3, 3, 9)
            for n in (3, 5, 9)]
    strides = (32, 16, 8)
    assert decode_form_for(maps) == "strided"           # h * w = n (n + 1) is not a multiple of 4
    before = decode_outputs_cuda.launches
    got = decode_outputs_cuda(maps, ANCHORS, strides, normalized)
    torch.cuda.synchronize()
    assert decode_outputs_cuda.launches == before + 3   # one a level
    want = torch.cat([decode_level(m, torch.tensor(a), float(s), normalized)
                      for m, a, s in zip(maps, ANCHORS, strides)], 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _boxes(rs, b, k, nc):
    cxy = rs.rand(b, k, 2)
    wh = rs.rand(b, k, 2) * 0.3 + 0.02
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    return (torch.from_numpy(boxes).cuda(), torch.from_numpy(rs.randint(0, nc, (b, k))
                                                             .astype(np.int32)).cuda(),
            torch.from_numpy(rs.rand(b, k) > 0.1).cuda())


def _nms_inputs(kind, b, k):
    """Random boxes of 3 classes, about 10% not valid; or the same boxes all
    of class 0 ("agnostic", as ``per_class=False`` sends them), none valid
    ("invalid"), a third of zero width and a third of zero size
    ("zero_area"); or one class in a chain where each box overlaps the next
    at IoU 7/13 and greedy keeps every other box ("chain")."""
    boxes, classes, valid = _boxes(np.random.RandomState(k), b, k, 3)
    if kind == "agnostic":
        classes = torch.zeros_like(classes)
    elif kind == "invalid":
        valid = torch.zeros_like(valid)
    elif kind == "zero_area":
        boxes[:, ::3, 2] = boxes[:, ::3, 0]
        boxes[:, 1::3, 2:] = boxes[:, 1::3, :2]
    elif kind == "chain":
        x = torch.arange(k, dtype=torch.float32, device=boxes.device) * 3.0
        boxes = torch.stack([x, torch.zeros_like(x), x + 10.0, torch.full_like(x, 10.0)], -1)
        boxes = boxes.expand(b, k, 4).contiguous()
        classes, valid = torch.zeros_like(classes), torch.ones_like(valid)
    return boxes, classes, valid


# the kernel, K, batch, inputs, IoU threshold: K1 around its 32-row chunks
# and up to K1_MAX, at batch 1, 16 and 40 (40 clusters of 8 CTAs are more
# than one wave on 132 SMs); thresholds 0 and -1 divide for every pair
NMS_CASES = [(nms_suppress, 300, 3, "random", 0.45), (nms_suppress, 1024, 3, "random", 0.45),
             (nms_suppress_tiled, 1500, 3, "random", 0.45),
             (nms_suppress_tiled, 4096, 3, "random", 0.45)]
NMS_CASES += [(nms_suppress, k, b, "random", 0.45) for k in (1, 31, 32, 33, 300, 1023, 1024)
              for b in (1, 16, 40)]
NMS_CASES += [(nms_suppress, k, b, kind, thr) for k, b, kind, thr in (
    (300, 16, "agnostic", 0.45), (1024, 16, "agnostic", 0.45), (300, 1, "chain", 0.45),
    (1024, 1, "chain", 0.45), (300, 4, "invalid", 0.45), (1024, 2, "invalid", 0.45),
    (300, 4, "zero_area", 0.45), (300, 4, "zero_area", -1.0), (1024, 2, "zero_area", 0.0),
    (300, 16, "random", 0.0), (300, 16, "random", -1.0), (1024, 3, "random", 0.0),
    (1024, 3, "random", -1.0))]


@pytest.mark.parametrize("kernel,k,b,kind,thr", NMS_CASES)
def test_nms_kernels_match_plain(cuda, kernel, k, b, kind, thr):
    args = _nms_inputs(kind, b, k)
    before = kernel.launches
    got = kernel(*args, thr)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got, suppress_plain(*args, thr))
    if kind == "chain":
        assert torch.equal(got, (torch.arange(k, device=cuda) % 2 == 0).expand(b, k))
    elif kind == "invalid":
        assert not got.any()
    elif k >= 300:
        assert 0 < int(got.sum()) < int(args[2].sum())       # suppression did real work


@pytest.mark.parametrize("k", [300, 1024])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_nms_suppress_every_cluster_size_matches_plain(cuda, k, cluster):
    """K1 at batch 40 in each cluster size, forced past ``cluster_size``
    (which gives 40 images 2 CTAs each on 132 SMs)."""
    args = _nms_inputs("random", 40, k)
    got = nms_k1k2._launch("nms_suppress", *args, 0.45, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, suppress_plain(*args, 0.45))


@pytest.mark.parametrize("cluster", [0, 9, 16])
def test_nms_suppress_raises_for_a_cluster_it_cannot_launch(cuda, cluster):
    with pytest.raises(RuntimeError, match="cudaError_t"):
        nms_k1k2._launch("nms_suppress", *_nms_inputs("random", 2, 300), 0.45, cluster=cluster)


@pytest.mark.parametrize("k,bs,nc", [(8192, 2, 3), (8192, 2, 80), (1025, 3, 3)])
def test_tiled_nms_kernel_matches_plain_at_large_k(cuda, k, bs, nc):
    args = _boxes(np.random.RandomState(k + nc), bs, k, nc)
    got = nms_suppress_tiled(*args, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got, suppress_plain(*args, 0.45))
    assert 0 < int(got.sum()) < int(args[2].sum())


def test_tiled_nms_kernel_keeps_every_other_box_of_a_chain(cuda):
    """Each box overlaps the next (IoU 7/13) and not the one after: the
    greedy keep-set is every other box, a 2048-deep chain for a fixpoint."""
    k = 2048
    x = torch.arange(k, dtype=torch.float32, device=cuda) * 3.0
    boxes = torch.stack([x, torch.zeros_like(x), x + 10.0, torch.full_like(x, 10.0)], -1)[None]
    classes = torch.zeros(1, k, dtype=torch.int32, device=cuda)
    valid = torch.ones(1, k, dtype=torch.bool, device=cuda)
    got = nms_suppress_tiled(boxes.contiguous(), classes, valid, 0.45)
    assert torch.equal(got[0], torch.arange(k, device=cuda) % 2 == 0)
    assert torch.equal(got, suppress_plain(boxes, classes, valid, 0.45))


def _suppress_plain_by_class(boxes, classes, valid, thr):
    """The plain keep-set class by class: exact, as the class-aware greedy
    keep-set is the union of the classes' own, and cheap at large K (a
    class's IoU matrix instead of a K x K one, 2.5 GB at K = 25,200)."""
    keep = torch.zeros_like(valid)
    for b in range(boxes.shape[0]):
        for c in classes[b].unique():
            idx = (classes[b] == c).nonzero().squeeze(1)
            keep[b, idx] = suppress_plain(boxes[b, idx][None], classes[b, idx][None],
                                          valid[b, idx][None], thr)[0]
    return keep


@pytest.mark.parametrize("k", [8193, 9601, 25200, nms_k1k2.K2_MAX])
def test_tiled_nms_kernel_matches_plain_up_to_k2_max(cuda, k):
    """K2 past its old 8192 ceiling: 5 chunks in the sweep's ring from
    K = 9601, 2 at a 640 px plan's 25,200 candidates and at K2_MAX; batch 2,
    boxes over 80 classes."""
    args = _boxes(np.random.RandomState(k), 2, k, 80)
    got = nms_suppress_tiled(*args, 0.45)
    torch.cuda.synchronize()
    assert torch.equal(got, _suppress_plain_by_class(*args, 0.45))
    assert 0 < int(got.sum()) < int(args[2].sum())


def test_suppress_above_k2_max_raises_a_documented_error(cuda):
    args = _boxes(np.random.RandomState(0), 1, nms_k1k2.K2_MAX + 1, 80)
    n2 = nms_suppress_tiled.launches
    with pytest.raises(ValueError, match=f"K2_MAX = {nms_k1k2.K2_MAX}"):
        suppress(*args, 0.45)
    with pytest.raises(ValueError, match=f"K <= {nms_k1k2.K2_MAX}"):
        nms_suppress_tiled(*args, 0.45)
    assert nms_suppress_tiled.launches == n2


# one train step on the card against the CPU (fp32): the tolerances of
# tests/test_torch_port_train.py (train-mode BN statistics summed in another
# order, amplified with depth; PERF.md)
STEP_LOSS_RTOL, STEP_REL_L2 = 1e-3, 3e-2


def _rel_l2(got, want):
    num = sum(float(((got[k].cpu().double() - want[k].double()) ** 2).sum()) for k in want)
    return (num / sum(float((want[k].double() ** 2).sum()) for k in want)) ** 0.5


def test_tiny_train_step_on_the_card_matches_the_cpu(cuda):
    """yolov7-tiny @128, batch 2, fp32: one Trainer.train_step on the card and
    one on the CPU from the same weights and batch: loss parts, num_fg,
    gradients and updates, and TF32 left off."""
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    plan = TrainPlan("cfg/coco_train.yaml")
    plan.model_cfg = "cfg/net/yolov7-tiny.yaml"
    plan.image_size, plan.batch_size, plan.max_boxes = 128, 2, 8
    cpu = Trainer(plan, device="cpu", dtype=torch.float32)
    gpu = Trainer(plan, device="cuda", dtype=torch.float32)
    assert not torch.backends.cudnn.allow_tf32
    sd = {k: v.clone() for k, v in cpu.init_state(seed=0)["model"].state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    for name, t in sd.items():       # O(1) activations through the depth
        if name.endswith("weight") and t.dim() == 4:
            t.normal_(0.0, (1.0 / t[0].numel()) ** 0.5, generator=gen)
        elif name.endswith(("running_mean", "bias")):
            t.normal_(0.0, 0.1, generator=gen)
    rs = np.random.RandomState(2)
    images = rs.rand(2, 128, 128, 3).astype(np.float32)
    labels = np.zeros((2, 8, 5), np.float32)
    labels[:, :3] = [[1, 0.5, 0.5, 0.4, 0.4], [3, 0.3, 0.3, 0.2, 0.25], [7, 0.7, 0.6, 0.3, 0.35]]
    lmask = np.zeros((2, 8), bool)
    lmask[:, :3] = True
    out = {}
    for tr in (cpu, gpu):
        state = tr.init_state(state_dict=sd)
        old = {k: v.detach().clone() for k, v in state["model"].state_dict().items()}
        _, parts = tr.train_step(state, images, labels, lmask, 0.01, 0.1, 0.937)
        out[tr.device.type] = (
            {k: float(v) for k, v in parts.items()},
            {n: p.grad.cpu() for n, p in state["model"].named_parameters()},
            {k: (v - old[k]).cpu() for k, v in state["model"].state_dict().items()
             if v.is_floating_point()})
    (pc, gc, uc), (pg, gg, ug) = out["cpu"], out["cuda"]
    assert pg["num_fg"] == pc["num_fg"] > 0
    for k in ("loss", "box", "obj", "cls"):
        assert abs(pg[k] - pc[k]) <= STEP_LOSS_RTOL * abs(pc[k]), k
    assert _rel_l2(gg, gc) <= STEP_REL_L2 and _rel_l2(ug, uc) <= STEP_REL_L2


def test_trainer_runs_on_the_card_in_bf16(cuda):
    """The default Trainer on the card: bf16 body, fp32 master weights and
    logits, a finite loss, weights that move."""
    from yolo_continuous_tpu_torch.train.train_loop import Trainer
    tr = Trainer(TrainPlan(tiny_plan_cfg("IAuxDetect", 64)))
    state = tr.init_state(seed=0)
    assert tr.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state["model"].parameters())
    w0 = state["model"].model[0].conv.weight.detach().clone()
    labels = np.zeros((2, 8, 5), np.float32)
    labels[:, 0] = [1, 0.5, 0.5, 0.4, 0.4]
    lmask = np.zeros((2, 8), bool)
    lmask[:, 0] = True
    _, parts = tr.train_step(state, np.random.RandomState(0).rand(2, 64, 64, 3), labels, lmask,
                             0.01, 0.1, 0.937)
    assert torch.isfinite(parts["loss"]) and int(parts["num_fg"]) > 0
    assert not torch.equal(state["model"].model[0].conv.weight, w0)


def test_suppress_dispatches_by_k(cuda):
    rs = np.random.RandomState(0)
    n1, n2 = nms_suppress.launches, nms_suppress_tiled.launches
    suppress(*_boxes(rs, 2, 1024, 3), 0.45)
    suppress(*_boxes(rs, 2, 1025, 3), 0.45)
    assert (nms_suppress.launches - n1, nms_suppress_tiled.launches - n2) == (1, 1)


@pytest.mark.parametrize("normalized", [True, False])
def test_bin_decode_kernel_matches_plain(cuda, normalized):
    """K4 on strided IBin views of NCHW maps, under the argmax-gap precondition."""
    rs = np.random.RandomState(1)
    maps = []
    for n in (9, 5, 3):
        p = ibin_logits(rs, (3, n, n + 1, 3), 4)
        assert min_bin_gap(p) > 1e-5
        bs, h, w, na, no = p.shape
        y = torch.from_numpy(p).permute(0, 3, 4, 1, 2).reshape(bs, na * no, h, w).contiguous()
        maps.append(head_view(y.to(cuda), na, no))
    anchors = ANCHORS[::-1]
    strides = (8, 16, 32)
    assert bin_decode.form_for(maps) == "strided"
    before = decode_outputs_bin_cuda.launches
    got = decode_outputs_bin_cuda(maps, anchors, strides, 21, normalized)
    torch.cuda.synchronize()
    assert decode_outputs_bin_cuda.launches == before + 3
    want = torch.cat([decode_level_bin(m, torch.tensor(a), float(s), 21, normalized)
                      for m, a, s in zip(maps, anchors, strides)], 1)
    assert got.shape == want.shape == (3, 3 * (90 + 30 + 12), 9)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# the TMA form of K3 and K4: four levels in one launch, among them a 20 x 20
# level (12.5 tiles of 32 pixels: a partial last tile) and a 2 x 2 one (one
# tile of 4 pixels); P6's anchors for the fourth
TMA_SIDES = (20, 2, 40, 80)
TMA_STRIDES = (32, 64, 16, 8)
TMA_ANCHORS = ANCHORS[:1] + (((436.0, 615.0), (739.0, 380.0), (925.0, 792.0)),) + ANCHORS[1:]
EDGE_LOGITS = (-90.0, -200.0, 90.0, 1e30, -1e30, -87.5)   # e^-v overflows, or 1/d is subnormal


def _edges(rs, p, cols):
    """p with every 11th value of the given columns set to an edge logit (11 is
    prime to the number of columns, so every column gets some)."""
    p = p.copy()
    sub = p[..., cols]
    flat = sub.reshape(-1)
    pick = np.arange(0, flat.size, 11)
    flat[pick] = rs.choice(EDGE_LOGITS, pick.size)
    p[..., cols] = flat.reshape(sub.shape)
    return p


def _nchw_views(arrays, device):
    """(bs, h, w, na, no) arrays -> head views of contiguous NCHW tensors."""
    views = []
    for p in arrays:
        bs, h, w, na, no = p.shape
        y = torch.from_numpy(np.ascontiguousarray(p)).permute(0, 3, 4, 1, 2).reshape(bs, na * no, h, w)
        views.append(head_view(y.contiguous().to(device), na, no))
    return views


def _decode_both_forms(maps, normalized, anchors=TMA_ANCHORS, strides=TMA_STRIDES):
    """K3 on maps in the TMA form (one launch) and the strided form."""
    assert decode_form_for(maps) == "tma"
    before = decode_outputs_cuda.launches
    got = decode_outputs_cuda(maps, anchors, strides, normalized)
    torch.cuda.synchronize()
    assert decode_outputs_cuda.launches == before + 1
    strided = decode.launch_form(maps, anchors, strides, normalized, "strided")
    want = torch.cat([decode_level(m, torch.tensor(a), float(s), normalized)
                      for m, a, s in zip(maps, anchors, strides)], 1)
    return got, strided, want


@pytest.mark.parametrize("bs", [1, 3])
@pytest.mark.parametrize("normalized", [True, False])
def test_decode_tma_form_matches_plain_and_strided(cuda, bs, normalized):
    rs = np.random.RandomState(bs)
    maps = _nchw_views([(rs.randn(bs, n, n, 3, 9) * 3).astype(np.float32) for n in TMA_SIDES], cuda)
    got, strided, want = _decode_both_forms(maps, normalized)
    assert got.shape == want.shape == (bs, 3 * sum(n * n for n in TMA_SIDES), 9)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, strided)


def test_decode_forms_at_the_edges_of_the_sigmoid(cuda):
    """Logits where e^-v overflows (-90, -200, -1e30), where 1/(1 + e^-v) is
    subnormal (-87.5) and where it saturates (90, 1e30), in every column:
    both forms agree with the plain version, and with each other bit for bit."""
    rs = np.random.RandomState(7)
    maps = _nchw_views([_edges(rs, (rs.randn(2, n, n, 3, 9) * 3).astype(np.float32), slice(None))
                        for n in TMA_SIDES], cuda)
    for normalized in (True, False):
        got, strided, want = _decode_both_forms(maps, normalized)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, strided)
    assert (got[..., 4:] == 0).any() and (got[..., 4:] == 1).any()


def test_decode_rejects_the_tma_form_for_maps_it_cannot_read(cuda):
    maps = [head_view(torch.zeros(1, 27, 3, 5, device=cuda), 3, 9)]     # h * w = 15
    before = decode_outputs_cuda.launches
    with pytest.raises(ValueError, match="form"):
        decode.launch_form(maps, ANCHORS[:1], (8,), True, "tma")
    assert decode_outputs_cuda.launches == before


def _bin_decode_both_forms(maps, normalized, anchors=TMA_ANCHORS, strides=TMA_STRIDES):
    assert bin_decode.form_for(maps) == "tma"
    before = decode_outputs_bin_cuda.launches
    got = decode_outputs_bin_cuda(maps, anchors, strides, 21, normalized)
    torch.cuda.synchronize()
    assert decode_outputs_bin_cuda.launches == before + 1
    strided = bin_decode.launch_form(maps, anchors, strides, 21, normalized, "strided")
    want = torch.cat([decode_level_bin(m, torch.tensor(a), float(s), 21, normalized)
                      for m, a, s in zip(maps, anchors, strides)], 1)
    return got, strided, want


@pytest.mark.parametrize("bs", [1, 3])
@pytest.mark.parametrize("normalized", [True, False])
def test_bin_decode_tma_form_matches_plain_and_strided(cuda, bs, normalized):
    """Under the argmax-gap precondition."""
    rs = np.random.RandomState(10 + bs)
    arrays = [ibin_logits(rs, (bs, n, n, 3), 4) for n in TMA_SIDES]
    assert min(min_bin_gap(p) for p in arrays) > 1e-5
    got, strided, want = _bin_decode_both_forms(_nchw_views(arrays, cuda), normalized)
    assert got.shape == want.shape == (bs, 3 * sum(n * n for n in TMA_SIDES), 9)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, strided)


def test_bin_decode_forms_at_the_edges_of_the_sigmoid(cuda):
    """Edge logits in x, y, obj and cls (the bins keep the argmax-gap
    precondition): both forms agree with the plain version, and with each
    other bit for bit."""
    rs = np.random.RandomState(8)
    cols = [0, 1] + list(range(2 + 2 * 22, 51))
    arrays = [_edges(rs, ibin_logits(rs, (2, n, n, 3), 4), cols) for n in TMA_SIDES]
    assert min(min_bin_gap(p) for p in arrays) > 1e-5
    maps = _nchw_views(arrays, cuda)
    for normalized in (True, False):
        got, strided, want = _bin_decode_both_forms(maps, normalized)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, strided)
    assert (got[..., 4:] == 0).any() and (got[..., 4:] == 1).any()


@pytest.mark.parametrize("no,form", [(151, "tma"), (152, "strided")])
def test_decode_forms_at_the_edge_of_shared_memory(cuda, no, form):
    """With 3 anchors, 151 columns is the widest head whose TMA block fits in
    227 KB: it takes the TMA form, bit-equal to the strided form; 152 takes
    the strided form, one launch a level."""
    rs = np.random.RandomState(no)
    maps = _nchw_views([(rs.randn(2, n, n, 3, no) * 3).astype(np.float32) for n in (4, 8)], cuda)
    anchors, strides = ANCHORS[:2], (32, 16)
    assert decode_form_for(maps) == form
    before = decode_outputs_cuda.launches
    got = decode_outputs_cuda(maps, anchors, strides)
    torch.cuda.synchronize()
    assert decode_outputs_cuda.launches == before + (1 if form == "tma" else 2)
    want = torch.cat([decode_level(m, torch.tensor(a), float(s))
                      for m, a, s in zip(maps, anchors, strides)], 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, decode.launch_form(maps, anchors, strides, True, "strided"))


@pytest.mark.parametrize("nc,form", [(125, "tma"), (126, "strided")])
def test_bin_decode_forms_at_the_edge_of_shared_memory(cuda, nc, form):
    """K4 with 3 anchors: 125 classes is the most whose TMA block fits in
    227 KB; 126 take the strided form."""
    rs = np.random.RandomState(nc)
    arrays = [ibin_logits(rs, (2, n, n, 3), nc) for n in (8, 4)]
    assert min(min_bin_gap(p) for p in arrays) > 1e-5
    maps = _nchw_views(arrays, cuda)
    anchors, strides = ANCHORS[::-1][:2], (8, 16)
    assert bin_decode.form_for(maps) == form
    before = decode_outputs_bin_cuda.launches
    got = decode_outputs_bin_cuda(maps, anchors, strides)
    torch.cuda.synchronize()
    assert decode_outputs_bin_cuda.launches == before + (1 if form == "tma" else 2)
    want = torch.cat([decode_level_bin(m, torch.tensor(a), float(s), 21)
                      for m, a, s in zip(maps, anchors, strides)], 1)
    assert got.shape == (2, 3 * 80, 5 + nc)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, bin_decode.launch_form(maps, anchors, strides, 21, True, "strided"))


# dtype, C_in, C_out, H, W: a main-path shape, a ragged one (vector loads),
# and ones whose C or H*W is not a multiple of 8 (element loads)
K5_CASES = [(torch.bfloat16, 512, 256, 20, 20), (torch.bfloat16, 1024, 200, 9, 16),
            (torch.bfloat16, 40, 24, 5, 7), (torch.float32, 512, 256, 10, 10),
            (torch.float32, 37, 19, 3, 5)]


@pytest.mark.parametrize("dtype,c,n,h,w", K5_CASES)
def test_fused_conv_kernel_matches_plain(cuda, dtype, c, n, h, w):
    g = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn(2, c, h, w, device=cuda, generator=g).to(dtype)
    wt = (torch.randn(n, c, device=cuda, generator=g) / c ** 0.5).to(dtype)
    scale = torch.rand(n, device=cuda, generator=g) + 0.5
    bias = torch.randn(n, device=cuda, generator=g) * 0.1
    before = fused_pointwise_conv_cuda.launches
    got = fused_pointwise_conv_cuda(x, wt, scale, bias)
    torch.cuda.synchronize()
    assert fused_pointwise_conv_cuda.launches == before + 1
    want = fused_pointwise_conv_plain(x, wt, scale, bias)
    assert got.dtype == dtype and got.shape == want.shape == (2, n, h, w)
    # bf16: one bf16 ulp (fp32 sums in another order round across a boundary)
    tol = dict(rtol=8e-3, atol=1e-3) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_detector_paths_launch_k4_and_k5(cuda):
    """IBin decodes through K4 (its 64 px maps take the TMA form: one launch
    for the 3 levels); fused_tails runs yolov7's 24 eligible Convs through
    K5."""
    det = Detector(TrainPlan(tiny_plan_cfg("IBin", 64)), device="cuda", seed=0)
    n4 = decode_outputs_bin_cuda.launches
    boxes, _, _, _ = det(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32), 0.01)
    torch.cuda.synchronize()
    assert decode_outputs_bin_cuda.launches - n4 == 1 and torch.isfinite(boxes).all()
    plan = TrainPlan("cfg/chip_tiny.yaml")
    plan.model_cfg, plan.image_size = "cfg/net/yolov7.yaml", 64
    plan.save_path = "/nonexistent/x.msgpack"
    det = Detector(plan, device="cuda", seed=0, fused_tails=True)
    n5 = fused_pointwise_conv_cuda.launches
    det.forward(np.zeros((1, 64, 64, 3), np.float32))
    torch.cuda.synchronize()
    assert fused_pointwise_conv_cuda.launches - n5 == 24


def _k5_args(device, b, c, n, h, w, dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(c * 7 + n + h)
    x = torch.randn(b, c, h, w, device=device, generator=g).to(dtype)
    wt = (torch.randn(n, c, device=device, generator=g) / c ** 0.5).to(dtype)
    scale = torch.rand(n, device=device, generator=g) + 0.5
    bias = torch.randn(n, device=device, generator=g) * 0.1
    return x, wt, scale, bias


@pytest.mark.parametrize("b", [2, 1])
@pytest.mark.parametrize("c,n,h,w", sorted(set(YOLOV7_640_FUSED_TAILS)))
def test_fused_conv_wgmma_form_at_main_path_shapes(cuda, c, n, h, w, b):
    """Each distinct shape of yolov7 @640's fused tails at batch 2, and at
    batch 1 (the bench's single-image fused-tail request): the wgmma + TMA
    form, within one bf16 ulp of the plain version, and bit-equal when run
    again."""
    args = _k5_args(cuda, b, c, n, h, w)
    assert form_for(args[0], args[1]) == "wgmma"
    got = fused_pointwise_conv_cuda(*args)
    again = fused_pointwise_conv_cuda(*args)
    torch.cuda.synchronize()
    assert got.shape == (b, n, h, w)
    torch.testing.assert_close(got.float(), fused_pointwise_conv_plain(*args).float(),
                               rtol=8e-3, atol=1e-3)
    assert torch.equal(got, again)


@pytest.mark.parametrize("c,n,h,w,form", [(520, 72, 9, 15, "mma_sync"), (36, 24, 5, 8, "mma_sync"),
                                          (1024, 200, 9, 16, "wgmma"), (520, 72, 8, 15, "wgmma"),
                                          (64, 8, 1, 8, "wgmma")])
def test_fused_conv_ragged_shapes_take_their_form(cuda, c, n, h, w, form):
    """C or H*W not a multiple of 8 take mma.sync; ragged channel and pixel
    tiles of the wgmma form are clipped by its TMA stores."""
    args = _k5_args(cuda, 3, c, n, h, w)
    assert form_for(args[0], args[1]) == form
    got = fused_pointwise_conv_cuda(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fused_pointwise_conv_plain(*args).float(),
                               rtol=8e-3, atol=1e-3)
    assert torch.equal(got, fused_pointwise_conv_cuda(*args))


def test_fused_conv_epilogue_reciprocal_is_exact(cuda):
    """The wgmma form's branch-free 1/d equals __fdiv_rn(1, d) on every
    float d in [1, 2^126), all 1.06e9 of them."""
    assert reciprocal_mismatches(cuda) == 0


def test_fused_conv_wgmma_form_where_exp_overflows(cuda):
    """Inputs 200x larger put a third of the y below -88.7, where e^-y
    overflows, and some in (-88.7, -87.3], where 1/d would be subnormal and
    the epilogue takes bn_silu: both agree with the plain version."""
    x, wt, scale, bias = _k5_args(cuda, 2, 512, 256, 20, 20)
    x = (x.float() * 200.0).bfloat16()
    got = fused_pointwise_conv_cuda(x, wt, scale, bias)
    want = fused_pointwise_conv_plain(x, wt, scale, bias)
    assert (want == 0).float().mean() > 0.1                 # many SiLUs rounded to -0
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the data path on the card: augmentation, the device pool, Trainer.run
# ---------------------------------------------------------------------------

def _aug_inputs(B, T, S=64, MB=8, seed=0):
    rs = np.random.RandomState(seed)
    tiles = rs.randint(0, 255, (B, T, S, S, 3)).astype(np.uint8)
    metas = np.zeros((B, T, 5), np.float32)
    boxes = np.zeros((B, T, MB, 5), np.float32)
    masks = np.zeros((B, T, MB), bool)
    for b in range(B):
        for t in range(T):
            iw, ih = rs.randint(30, 100), rs.randint(30, 100)
            r = min(S / iw, S / ih)
            metas[b, t] = [iw, ih, r, (S - int(iw * r)) // 2, (S - int(ih * r)) // 2]
            for i in range(rs.randint(0, 7)):
                bw, bh = rs.uniform(6, iw / 2), rs.uniform(6, ih / 2)
                x, y = rs.uniform(0, iw - bw), rs.uniform(0, ih - bh)
                boxes[b, t, i] = [x, y, x + bw, y + bh, rs.randint(3)]
                masks[b, t, i] = True
    return [torch.from_numpy(a) for a in (tiles, metas, boxes, masks)]


@pytest.mark.parametrize("T,extra", [(1, {}), (4, {}), (4, dict(copy_paste=0.5, flip_ud=0.5))])
def test_augment_on_the_card_matches_the_cpu(cuda, T, extra):
    """One parameter record, applied on the card and on the CPU: images
    within 1e-4 on 0..1 (the warps' sums in another order), boxes within
    1e-4 px, masks equal."""
    cfg = aug.AugConfig(size=64, **extra)
    inputs = _aug_inputs(4, T)
    mosaic, mixup = np.array([True, False, True, True]), np.array([True, True, False, True])
    draw = aug.draw_batch(torch.Generator().manual_seed(1), cfg, 4, T, 8, mosaic, mixup)
    want = aug.augment_batch(draw, *inputs, cfg=cfg, max_gt=24)
    got = aug.augment_batch(draw.to(cuda), *(a.to(cuda) for a in inputs), cfg=cfg, max_gt=24)
    assert got[0].device.type == cuda.type
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=1e-4 / 64)
    assert torch.equal(got[2].cpu(), want[2]) and want[2].any()


def test_augment_enqueues_without_a_host_sync(cuda):
    """From host arrays to labels, with every op on: nothing in the
    augmentation makes the host wait for the card (the Trainer syncs once
    an epoch)."""
    cfg = aug.AugConfig(size=64, copy_paste=0.5, flip_ud=0.5, equalize=0.5)
    inputs = [a.numpy() for a in _aug_inputs(4, 4)]
    mosaic, mixup = np.array([True, False, True, True]), np.array([True, True, False, True])
    draw = aug.draw_batch(torch.Generator().manual_seed(5), cfg, 4, 4, 8, mosaic, mixup)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = aug.augment_batch(draw.to(cuda), *(aug.to_device(a, cuda) for a in inputs),
                                cfg=cfg, max_gt=24)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out[0].device.type == cuda.type and torch.isfinite(out[0]).all()


def test_equalize_on_the_card_is_exact(cuda):
    img = torch.from_numpy(np.random.RandomState(2).rand(3, 32, 24, 3).astype(np.float32) * 255)
    img = torch.round(img)
    assert torch.equal(equalize(img.to(cuda)).cpu(), equalize(img))


def test_pool_staged_on_the_card(cuda):
    """The pool on the card: a gather of (B, T) indices gives the
    host-assembled batch's outputs bit for bit."""
    pool = [a[:, 0] for a in _aug_inputs(6, 1, seed=3)]
    tile_idx = torch.tensor([[0, 3, 5, 1], [2, 2, 2, 2], [4, 0, 1, 5]], dtype=torch.int32)
    mosaic, mixup = np.array([True, False, True]), np.array([True, True, False])
    cfg = aug.AugConfig(size=64)
    draw = aug.draw_batch(torch.Generator().manual_seed(4), cfg, 3, 4, 8, mosaic, mixup).to(cuda)
    got = aug.augment_batch_from_pool(draw, *(a.to(cuda) for a in pool), tile_idx.to(cuda),
                                      cfg=cfg, max_gt=16)
    host = aug.augment_batch(draw, *(a[tile_idx.long()].to(cuda) for a in pool), cfg=cfg,
                             max_gt=16)
    for g, h in zip(got, host):
        assert g.device.type == cuda.type and torch.equal(g, h)


def test_trainer_run_and_resume_on_the_card(cuda, tmp_path):
    """Trainer.run on the card, 2 epochs of the tiny IAuxDetect net with the
    real augmentation; then a run killed after epoch 1 and resumed. The
    resumed run must retrace the epoch lines to 4 decimals and end within
    1e-3 (relative L2) of the uninterrupted weights; whether it is bit-equal
    (cuDNN may pick another backward algorithm) is printed, not required."""
    pytest.importorskip("cv2")
    ann = write_dataset(tmp_path, 6, seed=5)
    cfg = tiny_plan_cfg("IAuxDetect", 64)
    cfg.update(train=ann, val=ann, epochs=2, save_dir=str(tmp_path / "a"), save_name="t",
               resume=False, enhance=True, mosaic_prob=0.7, mixup_prob=0.5, val_map_every=1)
    logs_a = []
    state_a = Trainer(TrainPlan(dict(cfg)), device="cuda").run(log=logs_a.append)
    assert state_a["step"] == 6 and any("val mAP" in l for l in logs_a)

    class Killed(Exception):
        pass

    def killer(line):
        if line.startswith("epoch 2/2 loss"):
            raise Killed

    cfg["save_dir"] = str(tmp_path / "b")
    with pytest.raises(Killed):
        Trainer(TrainPlan(dict(cfg)), device="cuda").run(log=killer)
    cfg["resume"] = True
    logs_b = []
    state_b = Trainer(TrainPlan(dict(cfg)), device="cuda").run(log=logs_b.append)
    assert "resumed at step 3" in logs_b
    strip = lambda ls: [" ".join(l.split()[:6]) for l in ls if l.startswith("epoch 2/2 loss")]
    assert strip(logs_b) == strip(logs_a)
    a, b = state_a["model"].state_dict(), state_b["model"].state_dict()
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in a
              if a[k].is_floating_point())
    den = sum(float((a[k].double() ** 2).sum()) for k in a if a[k].is_floating_point())
    print("resume on the card bit-equal:", all(torch.equal(a[k], b[k]) for k in a),
          "relative L2", (num / den) ** 0.5)
    assert (num / den) ** 0.5 <= 1e-3


def test_trainer_resume_on_the_card_is_bit_equal(cuda, tmp_path):
    """JAX's exact resume on the card: with cuDNN's deterministic algorithms
    (``Trainer`` sets them on CUDA), a run killed after epoch 1 and resumed
    from ``.last`` ends with the uninterrupted run's weights and EMA bit for
    bit."""
    pytest.importorskip("cv2")
    ann = write_dataset(tmp_path, 6, seed=5)
    cfg = tiny_plan_cfg("IAuxDetect", 64)
    cfg.update(train=ann, val=ann, epochs=2, save_dir=str(tmp_path / "a"), save_name="t",
               resume=False, enhance=True, mosaic_prob=0.7, mixup_prob=0.5, device_cache=False)
    state_a = Trainer(TrainPlan(dict(cfg)), device="cuda").run(log=lambda *_: None)
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark

    class Killed(Exception):
        pass

    def killer(line):
        if line.startswith("epoch 2/2 loss"):
            raise Killed

    cfg["save_dir"] = str(tmp_path / "b")
    with pytest.raises(Killed):
        Trainer(TrainPlan(dict(cfg)), device="cuda").run(log=killer)
    cfg["resume"] = True
    state_b = Trainer(TrainPlan(dict(cfg)), device="cuda").run(log=lambda *_: None)
    assert state_b["step"] == state_a["step"] == 6
    for part in ("model", "ema"):
        a, b = state_a[part].state_dict(), state_b[part].state_dict()
        assert set(a) == set(b)
        for k in a:
            if torch.is_tensor(a[k]):
                assert torch.equal(a[k], b[k]), f"{part}.{k}"


# ---------------------------------------------------------------- the JPEG stager

@pytest.mark.parametrize("size", [64, 63, 640])
def test_stage_letterbox_kernel_matches_plain(cuda, tmp_path, size):
    """Bit for bit on the same decoded pixels: down- and up-scales, 133 x 65
    at 640, 1 x 1, a grayscale JPEG, a canvas of fill; 63 px takes the
    kernel's byte stores."""
    from yolo_continuous_tpu_torch.kernels import staging
    files = write_staging_files(tmp_path)
    dec = staging.decode(staging.read_files(files), cuda)
    assert dec.ok.tolist() == [True] * (len(files) - 2) + [False, False]
    rows = [staging.canvas_row(dec, i, size, 128)[0] for i in np.nonzero(dec.ok)[0]]
    rows.append(staging.canvas_row(None, 0, size, 0)[0])
    geo = torch.tensor(rows, dtype=torch.int64)
    before = staging.stage_letterbox.launches
    got = staging.stage_letterbox(dec.src, geo.to(cuda), size)
    torch.cuda.synchronize()
    assert staging.stage_letterbox.launches == before + 1
    assert torch.equal(got.cpu(), staging.stage_letterbox_plain(dec.src.cpu(), geo, size))


def test_the_card_stages_what_the_cpu_stages(cuda, tmp_path):
    """``stage_batch_native`` on the card and on the CPU: the same decode,
    the kernel against its plain version, so tiles, metas and ``ok`` are
    equal end to end (the PNG named .jpg and the missing file fail in both)."""
    from yolo_continuous_tpu_torch.data.native_loader import stage_batch_native
    files = write_staging_files(tmp_path)
    for size in (64, 640):
        tiles, metas, ok = stage_batch_native(files, size, 128, cuda)
        want = stage_batch_native(files, size, 128, "cpu")
        assert tiles.device.type == "cuda" and ok.tolist() == want[2].tolist()
        np.testing.assert_array_equal(tiles.cpu().numpy(), want[0])
        np.testing.assert_array_equal(metas, want[1])


def _native_pair(tmp_path, cuda, **kw):
    from yolo_continuous_tpu_torch.data import dataset as pds
    ann = write_dataset(tmp_path, 7, seed=0)
    args = dict(image_size=64, max_boxes=8, mosaic_prob=0.7, mixup_prob=0.5, epoch_length=2,
                special_aug_ratio=0.5, seed=5, **kw)
    return (pds.YoloDataset(pds.load_annotation_file(ann), device=cuda, **args),
            pds.YoloDataset(pds.load_annotation_file(ann), use_native=True, **args))


def test_native_batches_stay_on_the_card(cuda, tmp_path):
    """A CUDA dataset stages through the card's stager by default, one
    launch a batch; its tiles stay on the card, and the batch and the pool
    equal the CPU's native stager's bit for bit."""
    from yolo_continuous_tpu_torch.kernels import staging
    gpu, cpu = _native_pair(tmp_path, cuda)
    assert gpu.use_native and cpu.use_native
    before = staging.stage_letterbox.launches
    got, want = gpu.batch([0, 3, 5]), cpu.batch([0, 3, 5])
    assert staging.stage_letterbox.launches == before + 1
    assert got[0].device.type == "cuda" and got[0].dtype == torch.uint8
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    pool, want = gpu.staged_pool(), cpu.staged_pool()
    assert pool[0].device.type == "cuda" and pool[0].shape[0] == 7
    np.testing.assert_array_equal(pool[0].cpu().numpy(), want[0])


def test_native_cache_stays_on_the_host(cuda, tmp_path, monkeypatch):
    """``cache_images`` on the card keeps decoded pixels in host memory,
    nothing on the card; a batch and a pool that hit the cache read no file
    and stage what the CPU stages, bit for bit."""
    from yolo_continuous_tpu_torch.kernels import staging
    gpu, cpu = _native_pair(tmp_path, cuda, cache_images=True)
    every = list(range(7))
    np.testing.assert_array_equal(gpu.batch(every)[0].cpu().numpy(), cpu.batch(every)[0])
    assert len(gpu._decoded) == 7
    assert all(isinstance(v, np.ndarray) for v in gpu._decoded.values())
    read, reads = staging.read_files, []
    monkeypatch.setattr(staging, "read_files", lambda paths: reads.extend(paths) or read(paths))
    got, want = gpu.batch([0, 3, 5]), cpu.batch([0, 3, 5])
    pool = gpu.staged_pool()
    assert reads == [] and got[0].device.type == "cuda"
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(pool[0].cpu().numpy(), cpu.staged_pool()[0])


def test_native_staging_enqueues_without_a_host_sync(cuda, tmp_path):
    """The Trainer's prefetch path with the card's stager: the loader
    thread stages on its own stream, the step's stream waits on the batch's
    event, and from files to augmented labels nothing makes the host wait."""
    from yolo_continuous_tpu_torch.data.dataset import PrefetchLoader
    gpu, _ = _native_pair(tmp_path, cuda)
    cfg = tiny_plan_cfg("Detect", 64)
    cfg.update(train=gpu.annotations[0].path, val=gpu.annotations[0].path, batch_size=3)
    trainer = Trainer(TrainPlan(dict(cfg)), device="cuda")
    gpu.reseed(0)
    gpu.staged_pool()                   # builds and warms the stager
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step, batch in enumerate(map(trainer._ready,
                                         PrefetchLoader(lambda: trainer._staged_batches(gpu)))):
            assert batch[0].device.type == "cuda"
            draw = trainer.draw(step, batch[0].shape[1], *batch[-2:])
            images, labels, lmask = trainer.augment(draw, batch, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert step == 1 and torch.isfinite(images).all()


def test_trainer_run_stages_with_the_card_stager(cuda, tmp_path):
    """``Trainer.run`` without the pool: every batch through the card's
    stager, and the pool path too."""
    from yolo_continuous_tpu_torch.kernels import staging
    ann = write_dataset(tmp_path, 6, seed=5)
    cfg = tiny_plan_cfg("Detect", 64)
    cfg.update(train=ann, val=ann, epochs=1, save_dir=str(tmp_path / "a"), save_name="t",
               resume=False, mosaic_prob=0.7, mixup_prob=0.5, device_cache=False)
    before = staging.stage_letterbox.launches
    trainer = Trainer(TrainPlan(dict(cfg)), device="cuda")
    state = trainer.run(log=lambda *_: None)
    (stats,) = trainer.epoch_stats
    assert state["step"] == 3 and not stats["device_cache"] and np.isfinite(stats["loss"])
    assert staging.stage_letterbox.launches - before >= 3       # the steps, and the val pass
    cfg.update(device_cache=True, save_dir=str(tmp_path / "b"))
    before = staging.stage_letterbox.launches
    Trainer(TrainPlan(dict(cfg)), device="cuda").run(log=lambda *_: None)
    assert staging.stage_letterbox.launches > before


# ---------------------------------------------------------------- the model zoo

P6_ANCHORS = [[19, 27, 44, 40, 38, 94], [96, 68, 86, 152, 180, 137],
              [140, 301, 303, 264, 238, 542], [436, 615, 739, 380, 925, 792]]


def _p6_plan(size):
    """tests/test_p6_model.py's plan: cfg/chip_tiny.yaml with yolov7-p6-lite,
    the P6 anchors and mask, 2 classes."""
    plan = TrainPlan("cfg/chip_tiny.yaml")
    plan.model_cfg, plan.anchors = "cfg/net/yolov7-p6-lite.yaml", P6_ANCHORS
    plan.anchors_mask = [[9, 10, 11], [6, 7, 8], [3, 4, 5], [0, 1, 2]]
    plan.image_size, plan.labels, plan.num_labels = size, ["a", "b"], 2
    plan.save_path = "/nonexistent/x.msgpack"
    return plan


@pytest.mark.parametrize("bs", [1, 3])
def test_p6_decode_takes_the_tma_form_at_four_levels(cuda, bs):
    """yolov7-p6-lite's head maps (128 px: 16, 8, 4, 2 cells a side): K3 in
    its TMA form, one launch for the four levels, bit-equal to the strided
    form and within 1e-5 of the plain version; a request launches K3 once and
    K1."""
    det = Detector(_p6_plan(128), device="cuda", dtype=torch.float32, seed=0)
    spread_weights(det.model, 3)
    images = np.random.RandomState(bs).rand(bs, 128, 128, 3).astype(np.float32)
    maps = det.forward(images)
    assert [m.shape[1] for m in maps] == [16, 8, 4, 2]
    for normalized in (True, False):
        got, strided, want = _decode_both_forms(maps, normalized, det.spec.anchors,
                                                det.spec.strides)
        assert got.shape == (bs, 3 * (256 + 64 + 16 + 4), 7)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, strided)
    n3, n1 = decode_outputs_cuda.launches, nms_suppress.launches
    boxes, scores, _, valid = det(images, 0.01, 0.45, 100)
    torch.cuda.synchronize()
    assert decode_outputs_cuda.launches - n3 == 1 and nms_suppress.launches - n1 == 1
    assert torch.isfinite(boxes).all() and bool(valid.any())


def _fuse_plan():
    cfg = tiny_plan_cfg("Detect", 96)
    cfg.update(model_cfg=FUSE_NET, save_dir="/nonexistent/")
    return TrainPlan(cfg)


def test_fuse_on_the_card(cuda):
    """Detector(fuse=True) on the card: the CPU's fused maps within 1e-4, the
    card's unfused maps within tests/test_fuse.py's 2e-3, no branch left; in
    bf16 finite. yolov7 with fuse and fused_tails launches K5 24 times."""
    plan = _fuse_plan()
    base = Detector(plan, device="cpu", seed=0)
    sd = spread_weights(base.model, 4).state_dict()
    x = np.random.RandomState(0).rand(2, 96, 96, 3).astype(np.float32)
    fused = Detector(plan, device="cuda", dtype=torch.float32, state_dict=sd, fuse=True)
    assert not any("rbr_dense" in k or "rbr_1x1" in k for k in fused.model.state_dict())
    cpu = Detector(plan, device="cpu", state_dict=sd, fuse=True).forward(x)
    plain = Detector(plan, device="cuda", dtype=torch.float32, state_dict=sd).forward(x)
    for g, c, p in zip(fused.forward(x), cpu, plain):
        torch.testing.assert_close(g.cpu(), c, rtol=0, atol=1e-4)
        torch.testing.assert_close(g, p, rtol=0, atol=2e-3)
    bf16 = Detector(plan, device="cuda", state_dict=sd, fuse=True)
    assert all(torch.isfinite(m).all() for m in bf16.forward(x))
    v7 = TrainPlan("cfg/chip_tiny.yaml")
    v7.model_cfg, v7.image_size, v7.save_path = "cfg/net/yolov7.yaml", 64, "/nonexistent/x.msgpack"
    det = Detector(v7, device="cuda", seed=0, fuse=True, fused_tails=True)
    n5 = fused_pointwise_conv_cuda.launches
    det.forward(np.zeros((1, 64, 64, 3), np.float32))
    torch.cuda.synchronize()
    assert fused_pointwise_conv_cuda.launches - n5 == 24


def test_bin_loss_step_on_the_card(cuda):
    """One train step of the tiny IBin net (bin_yolo_loss), fp32, on the card
    and on the CPU from the same weights: loss parts rtol 1e-4, num_fg equal,
    updated weights within 1e-3 relative L2."""
    cfg = tiny_plan_cfg("IBin", 64)
    sd = spread_weights(YoloModel(Trainer(TrainPlan(dict(cfg)), device="cpu").spec), 5).state_dict()
    rs = np.random.RandomState(6)
    images = rs.rand(2, 64, 64, 3).astype(np.float32)
    labels = np.zeros((2, 8, 5), np.float32)
    labels[:, 0] = [0, 0.5, 0.5, 0.4, 0.4]
    labels[:, 1] = [1, 0.3, 0.3, 0.2, 0.25]
    lmask = np.zeros((2, 8), bool)
    lmask[:, :2] = True
    out = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(TrainPlan(dict(cfg)), device=dev, dtype=torch.float32)
        state, parts = tr.train_step(tr.init_state(state_dict=sd), images, labels, lmask,
                                     0.01, 0.1, 0.937)
        out[dev] = ({k: float(v) for k, v in parts.items()},
                    {k: v.detach().cpu() for k, v in state["model"].state_dict().items()})
    (pc, wc), (pg, wg) = out["cpu"], out["cuda"]
    assert pg["num_fg"] == pc["num_fg"] > 0 and "bin" in pg
    for k in ("loss", "box", "obj", "cls", "bin"):
        assert abs(pg[k] - pc[k]) <= 1e-4 * abs(pc[k]), k
    keys = [k for k in wc if wc[k].is_floating_point()]
    num = sum(float(((wg[k].double() - wc[k].double()) ** 2).sum()) for k in keys)
    den = sum(float(((wc[k].double() - sd[k].double()) ** 2).sum()) for k in keys)
    assert (num / den) ** 0.5 <= 1e-3         # relative to the update itself


@pytest.mark.parametrize("group", sorted(ZOO_GROUPS) + sorted(ZOO_NETS) + ["yolobody-l"])
def test_zoo_rows_on_the_card(cuda, group):
    """Every chained group of the zoo's rows (tests/_torch_port.py), and
    YoloBody 'l', on the card in fp32 against the CPU: maps within 1e-4."""
    if group == "yolobody-l":
        model, size = YoloBody(2, "l"), 64
    else:
        cfg, size = zoo_net(group)
        model = YoloModel(build_model_spec(cfg, 3, ANCHOR_ROWS, 2))
    model = spread_weights(model, 7).eval()
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 3, size, size).astype(np.float32))
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4)


# ---------------------------------------------------------------- int8 PTQ and serving

INT8_SHAPES = [  # (x shape, w shape, stride, padding, groups, route)
    ((2, 3, 64, 64), (32, 3, 3, 3), 1, 1, 1, "gemm"),          # yolov7's stem, K 27 -> 32
    ((2, 32, 64, 64), (64, 32, 3, 3), 2, 1, 1, "gemm"),         # 3x3 stride 2
    ((2, 512, 20, 20), (256, 512, 1, 1), 1, 0, 1, "gemm"),      # 1x1: the activation multiplied
    ((1, 20, 5, 3), (12, 20, 3, 3), 2, 1, 1, "gemm"),           # M under 17, K and N padded
    ((2, 64, 16, 16), (64, 16, 3, 3), 1, 1, 4, "f64"),          # grouped
    ((2, 32, 16, 16), (32, 1, 3, 3), 2, 1, 32, "f64"),          # depthwise
]


@pytest.mark.parametrize("xs,ws,s,p,g,route", INT8_SHAPES)
def test_int8_routes_match_plain(cuda, xs, ws, s, p, g, route):
    """Each int8 route on the card: int32 accumulators bit-equal to the plain
    version's (an fp64 convolution on the CPU), outputs equal; the gemm
    shapes also through the taps route."""
    from yolo_continuous_tpu_torch.nn import quant as Q
    gen = torch.Generator().manual_seed(sum(xs) + sum(ws))
    x = (torch.randn(xs, generator=gen) * 2).to(torch.bfloat16)
    w = torch.randn(ws, generator=gen)
    amax = x.abs().amax().float() * 0.9
    assert Q.route_for(xs, ws, s, p, g) == route
    wq, sw = Q.quantize_weight(w)
    wq_g, sw_g = Q.quantize_weight(w.to(cuda))
    assert torch.equal(wq_g.cpu(), wq) and torch.equal(sw_g.cpu(), sw)
    sx = Q.activation_scale(amax)
    want = Q.accumulators_plain(x, sx, wq, s, p, g)
    mat = Q.gemm_weight(wq_g) if g == 1 else None
    routes = [route] + (["taps"] if route == "gemm" else [])
    for r in routes:
        got = Q.accumulators_cuda(x.to(cuda), sx.to(cuda), wq_g, mat, s, p, g, route=r)
        assert torch.equal(got.cpu(), want), r
        out = Q.dequantize(got, sx.to(cuda), sw_g, torch.bfloat16)
        assert torch.equal(out.cpu(), Q.dequantize(want, sx, sw, torch.bfloat16)), r


def test_int8_route_by_shape_and_the_shape_that_raises(cuda, monkeypatch):
    from yolo_continuous_tpu_torch.nn import quant as Q
    with pytest.raises(ValueError, match="overflow int32"):
        Q.route_for((1, 16000, 4, 4), (8, 16000, 3, 3), 1, 1, 1)
    x = torch.randn(2, 16, 24, 24, device=cuda)
    wq, _ = Q.quantize_weight(torch.randn(24, 16, 3, 3, device=cuda))
    with pytest.raises(ValueError, match="does not take"):
        Q.accumulators_cuda(x, torch.tensor(1.0, device=cuda), wq, None, 1, 1, 1, route="f64")
    monkeypatch.setattr(Q, "IM2COL_BYTES", 2 * 24 * 24 * 16 * 4)    # the im2col no longer fits
    assert Q.route_for(x.shape, wq.shape, 1, 1, 1) == "taps"
    sx = torch.tensor(0.03, device=cuda)
    got = Q.accumulators_cuda(x, sx, wq, Q.gemm_weight(wq), 1, 1, 1)
    assert torch.equal(got.cpu(), Q.accumulators_plain(x.cpu(), sx.cpu(), wq.cpu(), 1, 1, 1))


def test_quantized_detector_card_matches_cpu(cuda):
    """yolov7-tiny @64 int8 in fp32 on the card against the CPU, from the
    same weights and scales: maps within 1e-4, detections' keep-set equal."""
    plan = TrainPlan(tiny_plan_cfg("Detect", 64))
    plan.model_cfg = "cfg/net/yolov7-tiny.yaml"
    cpu = Detector(plan, device="cpu", dtype=torch.float32, quantize=True, seed=1)
    spread_weights(cpu.model, 1)
    sd = cpu.model.state_dict()
    cpu = Detector(plan, device="cpu", dtype=torch.float32, quantize=True, state_dict=sd)
    gpu = Detector(plan, device="cuda", dtype=torch.float32, quantize=True, state_dict=sd)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    gpu.load_quant_state(cpu.calibrate(x))
    for got, want in zip(gpu.forward(x), cpu.forward(x)):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_batching_engine_round_trip_on_the_card(cuda):
    """One BatchingEngine on a CUDA Detector: warm-up, a padded batch, K3
    and K1 launched for it, JSON-ready rows mapped to the original pixels."""
    from yolo_continuous_tpu_torch.serve import BatchingEngine
    plan = TrainPlan(tiny_plan_cfg("Detect", 64))
    det = Detector(plan, device="cuda", seed=0)
    eng = BatchingEngine(det, batch_size=4, max_wait_ms=2.0, conf=0.0, nms=0.5)
    try:
        n3, n1 = decode.decode_outputs_cuda.launches, nms_k1k2.nms_suppress.launches
        img = np.random.RandomState(0).randint(0, 255, (48, 80, 3)).astype(np.uint8)
        res = eng.submit(img)
        assert set(res) == {"boxes", "scores", "classes", "labels"} and res["boxes"]
        assert decode.decode_outputs_cuda.launches - n3 == 1
        assert nms_k1k2.nms_suppress.launches - n1 == 1
        from yolo_continuous_tpu_torch.ops.preprocess import letterbox
        from yolo_continuous_tpu_torch.serve import answers, detect_rows
        x = np.zeros((4, 64, 64, 3), np.float32)        # padded as the engine pads
        x[0] = letterbox(img, (64, 64), (114, 114, 114))[0].astype(np.float32) / 255.0
        rows = detect_rows(det, torch.from_numpy(x).to(cuda), 0.0, 0.5, 100)
        assert res == answers(rows, [img.shape[:2]], (64, 64), plan.labels)[0]
        assert eng.stats()["batches"] == 1 and eng.stats()["mean_batch_fill"] == 1.0
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the perspective, remat and the mesh on the card
# ---------------------------------------------------------------------------

def test_perspective_and_enhance_package_on_the_card(cuda):
    """The same draws on the card and on the CPU: images within 1e-2 on
    0..255 (grid_sample's bilinear weights), boxes and masks bit-equal (the
    corner transform is elementwise)."""
    from yolo_continuous_tpu_torch.ops.enhance import EnhancePackage, random_perspective
    rs = np.random.RandomState(0)
    img = torch.from_numpy(rs.randint(0, 256, (4, 48, 56, 3)).astype(np.float32))
    boxes = torch.from_numpy(np.concatenate([rs.uniform(0, 20, (4, 5, 2)),
                                             rs.uniform(25, 48, (4, 5, 2)),
                                             rs.randint(0, 3, (4, 5, 1))], -1).astype(np.float32))
    mask = torch.ones(4, 5, dtype=torch.bool)
    for persp in (0.0, 1e-3):
        pkg = EnhancePackage(64, {"equalize": 0.5, "scale_fill": 0.5, "perspective": persp},
                             use_perspective=True)
        draw = pkg.draw(torch.Generator().manual_seed(1), 4, 48, 56)
        cpu = pkg(draw, img, boxes, mask)
        card = pkg(draw.to(cuda), img.to(cuda), boxes.to(cuda), mask.to(cuda))
        torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=0, atol=1e-2)
        assert torch.equal(card[1].cpu(), cpu[1]) and torch.equal(card[2].cpu(), cpu[2])
        p = draw.enhance.perspective
        cpu = random_perspective(p, img, boxes, mask, persp)
        card = random_perspective(aug.to_record_device(p, cuda), img.to(cuda), boxes.to(cuda),
                                  mask.to(cuda), persp)
        torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=0, atol=1e-2)
        assert torch.equal(card[1].cpu(), cpu[1]) and torch.equal(card[2].cpu(), cpu[2])


def _tiny_step(cuda, remat=None, mesh=None, **keys):
    cfg = dict(tiny_plan_cfg("Detect", 64), model_cfg="cfg/net/yolov7-tiny.yaml", **keys)
    tr = Trainer(TrainPlan(cfg), device=cuda, dtype=torch.float32, remat=remat, mesh=mesh)
    state = tr.init_state(seed=0)
    if mesh is not None:
        from yolo_continuous_tpu_torch.parallel.mesh import shard_params
        shard_params(mesh, state)
    rs = np.random.RandomState(0)
    images = rs.rand(2, 64, 64, 3).astype(np.float32)
    labels = np.zeros((2, 8, 5), np.float32)
    labels[:, 0] = [0, 0.5, 0.5, 0.4, 0.4]
    lmask = np.zeros((2, 8), bool)
    lmask[:, 0] = True
    state, metrics = tr.train_step(state, images, labels, lmask, 0.01, 0.1, 0.937)
    return metrics, {k: v.detach().clone() for k, v in tr.model.state_dict().items()}


@pytest.mark.parametrize("bn_remat,remat", [(True, None), (False, "full"), (False, "conv"),
                                            (False, "dots")])
def test_remat_steps_on_the_card(cuda, bn_remat, remat):
    """The first forward is the plain one: loss parts and running statistics
    equal; the recomputed backward updates the weights within 1e-5 relative
    L2 of the plain step's (cuDNN may pick another algorithm)."""
    want, want_sd = _tiny_step(cuda)
    got, got_sd = _tiny_step(cuda, remat=remat, bn_remat=bn_remat)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in want_sd.items():
        if "running_" in k:
            assert torch.equal(got_sd[k], v), k
    num = sum(float(((got_sd[k] - v).double() ** 2).sum()) for k, v in want_sd.items()
              if v.is_floating_point())
    den = sum(float((v.double() ** 2).sum()) for v in want_sd.values() if v.is_floating_point())
    assert (num / den) ** 0.5 < 1e-5


def test_world_of_one_nccl_mesh_step_is_bit_equal(cuda, tmp_path, monkeypatch):
    """cuDNN in its deterministic mode: its default weight-gradient
    algorithms sum with atomics, so two plain steps differ in the last bits."""
    from yolo_continuous_tpu_torch.parallel import distributed as D
    from yolo_continuous_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    want, want_sd = _tiny_step(cuda, bn_remat=True)
    D.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cuda", timeout_s=60)
    try:
        assert torch.distributed.get_backend() == "nccl"
        got, got_sd = _tiny_step(cuda, mesh=make_mesh(1, 1), bn_remat=True)
    finally:
        D.shutdown()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """A 1 x 2 mesh of two processes on the one card, meeting through gloo
    (NCCL puts no two ranks on one device): the sharded convolutions,
    depthwise and RepConv slices and gathered implicits on CUDA tensors,
    against the 1-process fp32 step on the card (rtol 1e-4: cuDNN may pick
    other algorithms for the channel slices)."""
    import test_torch_port_distributed as TD
    got = TD._run_ranks(tmp_path, 1, 2, "shallow", False, device="cuda")
    metrics, state = TD._single_process("shallow", False, device=cuda)
    assert any(k.endswith("implicit") for k in got["shards"])
    for k in ("loss", "box", "obj", "cls"):
        np.testing.assert_allclose(float(got["metrics"][k]), float(metrics[k]), rtol=1e-4,
                                   err_msg=k)
    assert TD._rel_l2(got["state"]["model"], state["model"].state_dict()) < 1e-4


# --------------------------------------------------------------------------- batch 1, the bench's
# single-image requests (yolo_continuous_tpu_torch/bench.py): K3 on the three
# 640 px levels of a bf16 head (cast to fp32, as the decode does), K1 at
# 300 x 1 through nms_single (K5 at batch 1: test_fused_conv_wgmma_form_at_main_path_shapes)

@pytest.mark.parametrize("normalized", [True, False])
def test_decode_tma_form_on_a_bf16_head_at_batch_one(cuda, normalized):
    """yolov7 @640's three levels at batch 1, 80 classes, from bf16 head maps
    cast to fp32 as ``decode_outputs`` casts them: one TMA launch, equal to
    the strided form and to the plain version."""
    rs = np.random.RandomState(7)
    maps = [m.to(torch.bfloat16).float()
            for m in _nchw_views([(rs.randn(1, n, n, 3, 85) * 3).astype(np.float32)
                                  for n in (20, 40, 80)], cuda)]
    got, strided, want = _decode_both_forms(maps, normalized, ANCHORS, (32, 16, 8))
    assert got.shape == want.shape == (1, 25200, 85)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, strided)


def test_bench_nms_single_on_the_card_matches_the_cpu(cuda):
    """``nms_single`` of the bench's first 25,200 x 85 draw: K1 at 300 x 1 on
    the card gives the CPU's (plain) detections exactly."""
    from yolo_continuous_tpu_torch import bench
    from yolo_continuous_tpu_torch.ops.nms import nms_single
    p = torch.from_numpy(bench.infer_inputs(1, 64)[2][0])
    before = nms_suppress.launches
    got = nms_single(p.to(cuda), 0.25, 0.45, 300)
    torch.cuda.synchronize()
    assert nms_suppress.launches == before + 1
    for g, w in zip(got, nms_single(p, 0.25, 0.45, 300)):
        assert torch.equal(g.cpu(), w)


def test_bench_sections_run_on_the_card(cuda, capsys):
    """The bench's train and infer sections on the card (yolov7-tiny @64,
    batch 2): a positive rate and every key of the JAX bench > 0."""
    import json
    import math
    from yolo_continuous_tpu_torch import bench
    tiny = {"model_cfg": "cfg/net/yolov7-tiny.yaml"}
    assert bench.bench_train(2, size=64, iters=2, extra_cfg=tiny, device="cuda") > 0
    bench.section_infer(batch=2, size=64, iters=2, extras=("fused_tails", "int8"), device="cuda",
                        extra_cfg=tiny)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == sorted(("infer_img_s", "infer_1_ms", "nms_p50_ms",
                                   "infer_1_ms_fused_tails", "infer_img_s_int8"))
    assert all(math.isfinite(v) and v > 0 for v in line.values())


# ---------------------------------------------------------------------------
# the captured request (utils/capture.py): Detector.__call__ replays one CUDA
# graph per (conf, nms, max_det) and input shape; every route bit-equal to
# the eager request (Detector.infer_eager) in the same process

def _yolov7_plan(size, model_cfg="cfg/net/yolov7.yaml", save_path="/nonexistent/x.msgpack"):
    plan = TrainPlan("cfg/chip_tiny.yaml")
    plan.model_cfg, plan.image_size, plan.save_path = model_cfg, size, save_path
    return plan


def _bit_equal(got, want, what):
    for name, g, w in zip(("boxes", "scores", "classes", "valid"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {name}"
        assert torch.equal(g, w), f"{what}: {name} differs"


def _replay_matches_eager(det, x, key, kernels=()):
    """Eager twice (bit-equal: the oracle is deterministic), then two calls
    of ``det`` (the first captures): both bit-equal to eager; the graph
    recorded each kernel of ``kernels`` and the counters moved by its record
    once a replay. Returns the ``CapturedCall``."""
    want = det.infer_eager(x, *key)
    _bit_equal(det.infer_eager(x, *key), want, "eager against eager")
    before = {fn: fn.launches for fn in (decode_outputs_cuda, decode_outputs_bin_cuda,
                                         nms_suppress, nms_suppress_tiled,
                                         fused_pointwise_conv_cuda)}
    got = [det(x, *key), det(x, *key)]
    torch.cuda.synchronize()
    for g in got:
        _bit_equal(g, want, "replay against eager")
    call = det._infer[(tuple(x.shape), x.dtype)]
    assert len(det._infer) == 1 and det._infer_key == key
    for name in kernels:
        assert call.launches.get(name, 0) > 0, f"{name} not in the graph: {call.launches}"
    for fn, n in before.items():
        assert fn.launches - n == 2 * call.launches.get(fn.__name__, 0), fn.__name__
    return call


KEY = (0.01, 0.45, 300)
CAPTURE_ROUTES = {
    # route: (plan, Detector keywords, batch sizes, kernels in the graph)
    "detect": (lambda: _yolov7_plan(64), {}, (2, 1), ("decode_outputs_cuda", "nms_suppress")),
    "detect_head_bf16": (lambda: _yolov7_plan(64), dict(head_dtype=torch.bfloat16), (2, 1),
                         ("decode_outputs_cuda", "nms_suppress")),
    "ibin": (lambda: TrainPlan(tiny_plan_cfg("IBin", 64)), {}, (2,),
             ("decode_outputs_bin_cuda", "nms_suppress")),
    "iaux": (lambda: TrainPlan(tiny_plan_cfg("IAuxDetect", 64)), {}, (2,),
             ("decode_outputs_cuda", "nms_suppress")),
    "fused_tails": (lambda: _yolov7_plan(64), dict(fused_tails=True), (2, 1),
                    ("fused_pointwise_conv_cuda", "decode_outputs_cuda", "nms_suppress")),
    "fuse": (_fuse_plan, dict(fuse=True), (2,), ("decode_outputs_cuda", "nms_suppress")),
    "p6_lite": (lambda: _p6_plan(128), {}, (2,), ("decode_outputs_cuda", "nms_suppress")),
}


@pytest.mark.parametrize("route", sorted(CAPTURE_ROUTES))
def test_captured_request_is_bit_equal_to_eager(cuda, route):
    make_plan, kw, batches, kernels = CAPTURE_ROUTES[route]
    plan = make_plan()
    base = Detector(plan, device="cpu", seed=0, fuse=False)
    sd = spread_weights(base.model, 2).state_dict()
    det = Detector(plan, device="cuda", state_dict=sd, **kw)
    for bs in batches:
        x = torch.from_numpy(np.random.RandomState(bs).rand(
            bs, plan.image_size, plan.image_size, 3).astype(np.float32)).to(cuda)
        call = _replay_matches_eager(det, x, KEY, kernels)
        if route == "fused_tails":
            assert call.launches["fused_pointwise_conv_cuda"] == 24
        det._drop_graphs()


def test_captured_request_takes_k2_at_max_det_4096(cuda):
    """160 px gives 1575 candidates an image: K = 1575 > 1024 takes K2's two
    launches inside the graph."""
    det = Detector(_yolov7_plan(160), device="cuda", seed=0)
    spread_weights(det.model, 2)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 160, 160, 3).astype(np.float32)).cuda()
    call = _replay_matches_eager(det, x, (0.0, 0.45, 4096), ("nms_suppress_tiled",))
    assert "nms_suppress" not in call.launches


def _int8_detector():
    plan = TrainPlan(tiny_plan_cfg("Detect", 64))
    plan.model_cfg = "cfg/net/yolov7-tiny.yaml"
    sd = spread_weights(Detector(plan, device="cpu", seed=1).model, 1).state_dict()
    return Detector(plan, device="cuda", quantize=True, state_dict=sd)


def test_captured_int8_request_after_calibrate_and_after_load_quant_state(cuda):
    """int8: replay bit-equal to eager after ``calibrate``; ``load_quant_state``
    drops the graph and the next replay serves the new scales, bit-equal to
    eager with them."""
    from yolo_continuous_tpu_torch.nn import quant as Q
    det = _int8_detector()
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)).cuda()
    det.calibrate(x)
    Q.route_calls.clear()
    call = _replay_matches_eager(det, x, KEY, ("decode_outputs_cuda", "nms_suppress"))
    assert call.launches.get("route gemm", 0) > 0       # two eager requests, two replays
    assert Q.route_calls["gemm"] == 4 * call.launches["route gemm"]
    before = det(x, *KEY)
    det.load_quant_state({k: v * 1.5 for k, v in det.model.quant_state().items()})
    assert det._infer == {}
    after = _replay_matches_eager(det, x, KEY)
    assert after is not call
    assert not torch.equal(det(x, *KEY)[0], before[0])


def test_reload_weights_between_two_replays(cuda, tmp_path):
    """A replay, ``reload_weights`` of other weights, a replay: the second
    equals a fresh Detector on that checkpoint bit for bit."""
    import os
    plan = _yolov7_plan(64, save_path=str(tmp_path / "w.msgpack"))
    det = Detector(plan, device="cuda", seed=0)
    spread_weights(det.model, 2)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)).cuda()
    first = det(x, *KEY)
    sd = spread_weights(Detector(plan, device="cpu", seed=0).model, 5).state_dict()
    torch.save(sd, os.path.splitext(plan.save_path)[0] + ".pth")
    assert det.reload_weights() is True and det._infer == {}
    second = det(x, *KEY)
    fresh = Detector(plan, device="cuda")
    _bit_equal(second, fresh.infer_eager(x, *KEY), "replay after reload against a fresh eager")
    _bit_equal(second, fresh(x, *KEY), "replay after reload against a fresh replay")
    assert not torch.equal(first[1], second[1])


def test_a_failed_capture_raises_and_runs_nothing_eagerly(cuda, monkeypatch):
    """A host sync inside the captured function (here a ``.item()`` slipped
    into ``top_candidates``) fails the capture: ``CaptureError`` names the
    stage and the kernels recorded until then; no graph is kept, no counter
    moves and nothing is returned."""
    from yolo_continuous_tpu_torch.ops import nms as nms_ops
    from yolo_continuous_tpu_torch.utils.capture import CapturedCall, CaptureError
    with pytest.raises(CaptureError, match="capture failed"):
        CapturedCall(lambda x: x * float(x.sum().item()), torch.ones(4, device=cuda))
    det = Detector(_yolov7_plan(64), device="cuda", seed=0)
    real = nms_ops.top_candidates

    def syncing(pred, conf, k):
        out = real(pred, conf, k)
        float(out[1].sum().item())
        return out
    monkeypatch.setattr(nms_ops, "top_candidates", syncing)
    x = torch.zeros(2, 64, 64, 3, device=cuda)
    n3 = decode_outputs_cuda.launches
    with pytest.raises(CaptureError, match="capture failed after recording decode_outputs_cuda"):
        det(x, *KEY)
    torch.cuda.synchronize()
    assert det._infer == {} and decode_outputs_cuda.launches == n3
    monkeypatch.setattr(nms_ops, "top_candidates", real)
    _replay_matches_eager(det, x, KEY, ("decode_outputs_cuda", "nms_suppress"))


def test_capture_while_another_thread_works_on_its_own_stream(cuda):
    """A thread allocating, copying from pinned memory and multiplying on its
    own stream through the whole capture (as the train loader stages while
    ``validate_map`` captures): the capture succeeds (thread-local mode) and
    replays bit-equal to eager; the thread's results stay right."""
    import threading
    det = Detector(_yolov7_plan(64), device="cuda", seed=0)
    spread_weights(det.model, 2)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)).cuda()
    stop, errors, rounds = threading.Event(), [], [0]

    def work():
        try:
            stream = torch.cuda.Stream()
            with torch.cuda.stream(stream):
                while not stop.is_set():
                    host = torch.full((256, 256), 2.0).pin_memory()
                    a = host.to(cuda, non_blocking=True)
                    b = torch.empty(256, 256, device=cuda).fill_(0.5)
                    if float((a @ b)[0, 0]) != 256.0:
                        errors.append("wrong product")
                    rounds[0] += 1
        except Exception as e:          # reported by the test below
            errors.append(repr(e))

    t = threading.Thread(target=work)
    t.start()
    try:
        while rounds[0] == 0 and not errors:
            pass
        _replay_matches_eager(det, x, KEY, ("decode_outputs_cuda", "nms_suppress"))
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors and rounds[0] > 0


def test_captured_outputs_are_fresh_and_the_pool_goes_with_the_detector(cuda):
    """Two replays on other images: distinct tensors, the first left as it
    was; dropping the Detector gives its graph's memory back (measured after
    a first capture, which sets up what a process keeps: handles and
    workspaces of the capture stream)."""
    import gc
    rs = np.random.RandomState(0)
    a, b = (torch.from_numpy(rs.rand(2, 64, 64, 3).astype(np.float32)).cuda() for _ in range(2))
    Detector(_yolov7_plan(64), device="cuda", seed=0)(a, *KEY)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    det = Detector(_yolov7_plan(64), device="cuda", seed=0)
    spread_weights(det.model, 2)
    first = det(a, *KEY)
    kept = [t.clone() for t in first]
    second = det(b, *KEY)
    torch.cuda.synchronize()
    _bit_equal(first, kept, "the first result after a second call")
    _bit_equal(second, det.infer_eager(b, *KEY), "the second call")
    assert all(t1.data_ptr() != t2.data_ptr() for t1, t2 in zip(first, second))
    call = det._infer[(tuple(a.shape), a.dtype)]
    assert call.pool_bytes > 0 and call.capture_ms > 0
    del det, call, first, second, kept
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base


# the captured train step (utils/capture.CapturedStep): on CUDA
# Trainer.jitted_train_step() replays one graph per input shape and dtype;
# its first call is the warm-up and a real step. Each test holds it bit for
# bit to the eager train_step of a twin Trainer (cuDNN deterministic, the
# Trainer's setting on CUDA) over steps whose lr_w, lr_b and mom all change.

RAMP = [(0.0025 * i, 0.1 - 0.0125 * i, 0.8 + 0.02 * i) for i in range(1, 7)]


def _yolov7_tiny_cfg(**keys):
    return dict(tiny_plan_cfg("Detect", 64), model_cfg="cfg/net/yolov7-tiny.yaml", **keys)


def _twins(cuda, cfg, remat=None):
    """Two Trainers of one plan, each with the state of seed 0: the first
    steps through the captured step, the second eagerly."""
    out = []
    for _ in range(2):
        tr = Trainer(TrainPlan(dict(cfg)), device=cuda, remat=remat)
        out += [tr, tr.init_state(seed=0)]
    return out


def _train_batch(seed, bs=2, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    images = torch.from_numpy(rs.rand(bs, 64, 64, 3).astype(np.float32)).to("cuda", dtype)
    labels = np.zeros((bs, 8, 5), np.float32)
    lmask = np.zeros((bs, 8), bool)
    for b in range(bs):
        for g in range(2 + b % 2):
            labels[b, g] = [rs.randint(2), rs.uniform(.25, .75), rs.uniform(.25, .75),
                            rs.uniform(.15, .5), rs.uniform(.15, .5)]
            lmask[b, g] = True
    return images, torch.from_numpy(labels).cuda(), torch.from_numpy(lmask).cuda()


def _state_tensors(state) -> dict:
    out = {f"model.{k}": v for k, v in state["model"].state_dict().items()}
    out.update({f"ema.{k}": v for k, v in state["ema"].tree.items()})
    for i, st in state["opt"].state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


def _steps_bit_equal(twins, batches, hypers=RAMP):
    """Each batch through both twins: metrics equal bit for bit every step,
    then every tensor of the two states (the model's parameters and buffers,
    the EMA, the optimizer's buffers) and the counters. Returns the
    captured twin's graphs."""
    tr, state, eager, estate = twins
    step = tr.jitted_train_step()
    assert step == tr._replayed_step and eager.train_step != step
    for i, (batch, hyper) in enumerate(zip(batches, hypers)):
        _, got = step(state, *batch, *hyper)
        _, want = eager.train_step(estate, *batch, *hyper)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), f"step {i}: {k}"
    torch.cuda.synchronize()
    a, b = _state_tensors(state), _state_tensors(estate)
    assert a.keys() == b.keys()
    for k, v in b.items():
        assert torch.equal(a[k], v), k
    assert (state["step"], state["ema"].updates) == (estate["step"], estate["ema"].updates)
    return tr._graphs


@pytest.mark.parametrize("head", ["Detect", "IAuxDetect", "IBin"])
def test_captured_step_is_bit_equal_to_eager(cuda, head):
    """Detect on yolov7-tiny, IAuxDetect and IBin on the tiny nets: five
    steps, one graph, four replays."""
    cfg = _yolov7_tiny_cfg() if head == "Detect" else tiny_plan_cfg(head, 64)
    graphs = _steps_bit_equal(_twins(cuda, cfg), [_train_batch(s) for s in range(5)])
    (call,) = graphs.values()
    assert call.graph is not None and call.warmup_ms > 0 and call.capture_ms > 0
    assert call.pool_bytes > 0 and call.launches == {}       # no kernel of the port


@pytest.mark.parametrize("bn_remat,remat", [(True, None), (False, "full"), (False, "conv"),
                                            (False, "dots")])
def test_captured_step_under_remat_is_bit_equal(cuda, bn_remat, remat):
    """``bn_remat`` and the three ``remat`` policies: the checkpoints'
    recomputed forwards inside the graph."""
    twins = _twins(cuda, _yolov7_tiny_cfg(bn_remat=bn_remat), remat=remat)
    _steps_bit_equal(twins, [_train_batch(s) for s in range(5)])


def test_captured_adam_step_is_bit_equal(cuda):
    """Adam: its step count and bias corrections on the card, in the graph."""
    twins = _twins(cuda, _yolov7_tiny_cfg(adam=True))
    _steps_bit_equal(twins, [_train_batch(s) for s in range(5)])
    assert float(twins[1]["opt"]._t) == 5.0


def test_captured_step_takes_bf16_images_and_a_partial_batch(cuda):
    """bf16 images (the bench's) and a partial last batch (``drop_last:
    false``) each take a graph of their own, beside the fp32 full batch."""
    batches = [_train_batch(0), _train_batch(1, dtype=torch.bfloat16), _train_batch(2, bs=1),
               _train_batch(3), _train_batch(4, dtype=torch.bfloat16), _train_batch(5, bs=1)]
    graphs = _steps_bit_equal(_twins(cuda, _yolov7_tiny_cfg()), batches)
    assert len(graphs) == 3


def test_try_load_between_replays(cuda, tmp_path):
    """A checkpoint loads in place (the optimizer's buffers too): the graph
    stays and its next replay trains from the loaded state, as the eager
    step does."""
    from yolo_continuous_tpu_torch.train.checkpoint import save_checkpoint, try_load
    twins = _twins(cuda, _yolov7_tiny_cfg())
    _steps_bit_equal(twins, [_train_batch(0), _train_batch(1)], RAMP[:2])
    path = str(tmp_path / "a.train.pt")
    save_checkpoint(path, twins[1])
    _steps_bit_equal(twins, [_train_batch(2)], RAMP[2:3])
    assert try_load(path, twins[1]) is twins[1] and try_load(path, twins[3]) is twins[3]
    graphs = _steps_bit_equal(twins, [_train_batch(3), _train_batch(4)], RAMP[3:5])
    (call,) = graphs.values()
    assert twins[1]["step"] == 4


def test_a_host_sync_in_the_loss_fails_the_step_capture(cuda, monkeypatch):
    """A ``.item()`` slipped into the loss: the first call's warm-up runs
    (one real step), the capture fails with ``CaptureError``, and every later
    call raises it again without running anything."""
    from yolo_continuous_tpu_torch.utils.capture import CaptureError
    tr, state = _twins(cuda, _yolov7_tiny_cfg())[:2]
    real = tr.loss_from_outputs

    def syncing(outs, labels, lmask):
        loss, parts = real(outs, labels, lmask)
        float(loss.item())
        return loss, parts
    monkeypatch.setattr(tr, "loss_from_outputs", syncing)
    batch = _train_batch(0)
    with pytest.raises(CaptureError, match="capture failed"):
        tr.jitted_train_step()(state, *batch, *RAMP[0])
    torch.cuda.synchronize()
    before = {k: v.clone() for k, v in _state_tensors(state).items()}
    with pytest.raises(CaptureError, match="capture failed"):
        tr.jitted_train_step()(state, *batch, *RAMP[1])
    torch.cuda.synchronize()
    for k, v in _state_tensors(state).items():
        assert torch.equal(v, before[k]), k


def test_step_capture_while_a_loader_thread_stages(cuda):
    """A thread pinning host batches and copying them to the card on its own
    stream through the whole first call (warm-up and capture), as the
    prefetch loader of ``Trainer.run`` does: the capture succeeds
    (thread-local mode) and the steps stay bit-equal to eager."""
    import threading
    stop, errors, rounds = threading.Event(), [], [0]

    def stage():
        try:
            side = torch.cuda.Stream()
            while not stop.is_set():
                with torch.cuda.stream(side):
                    host = torch.from_numpy(np.full((2, 64, 64, 3), 0.5, np.float32)).pin_memory()
                    dev = host.to(cuda, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(side)
                ready.synchronize()
                if float(dev.sum()) != 0.5 * dev.numel():
                    errors.append("wrong copy")
                rounds[0] += 1
        except Exception as e:          # reported below
            errors.append(repr(e))

    t = threading.Thread(target=stage)
    t.start()
    try:
        while rounds[0] == 0 and not errors:
            pass
        _steps_bit_equal(_twins(cuda, _yolov7_tiny_cfg()), [_train_batch(s) for s in range(3)])
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors and rounds[0] > 0


def test_a_mesh_trainer_steps_eagerly_on_the_card(cuda, tmp_path):
    """A world-of-one NCCL mesh: ``jitted_train_step()`` is the eager step
    (its collectives are not captured), bit-equal to the meshless step."""
    from yolo_continuous_tpu_torch.parallel import distributed as D
    from yolo_continuous_tpu_torch.parallel.mesh import make_mesh, shard_params
    cfg = _yolov7_tiny_cfg()
    tr, state, _, _ = _twins(cuda, cfg)
    batch = _train_batch(0)
    _, want = tr.train_step(state, *batch, *RAMP[0])
    D.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cuda", timeout_s=60)
    try:
        meshed = Trainer(TrainPlan(dict(cfg)), device=cuda, mesh=make_mesh(1, 1))
        mstate = shard_params(meshed.mesh, meshed.init_state(seed=0))
        step = meshed.jitted_train_step()
        assert step == meshed.train_step
        _, got = step(mstate, *batch, *RAMP[0])
    finally:
        D.shutdown()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_a_dropped_trainer_frees_its_step_graph_at_once(cuda):
    """No reference cycle holds a captured step (it lets its function go
    after the first call): with the collector off, a dropped Trainer and its
    graph go at once. A graph left to a later collection could be finalized
    inside another capture, on its thread, whose ``cudaGraphExecDestroy``
    would invalidate that capture."""
    import gc
    import weakref
    tr, state = _twins(cuda, _yolov7_tiny_cfg())[:2]
    tr.jitted_train_step()(state, *_train_batch(0), *RAMP[0])
    (call,) = tr._graphs.values()
    assert call.graph is not None and call._fn is None
    refs = [weakref.ref(tr), weakref.ref(call.graph)]
    gc.collect()
    gc.disable()
    try:
        del tr, state, call
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
