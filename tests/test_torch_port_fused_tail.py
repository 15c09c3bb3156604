"""PyTorch port vs JAX package: the fused 1x1-tail serving option.

``layers.Conv(fused_tail=True)`` folds BN in fp32 and runs one fused conv +
BN + SiLU (kernel K5 on CUDA, its plain version here on the CPU); the JAX
side runs its Pallas kernel in interpret mode, as tests/test_fused_tail.py
does. Tolerances are those of tests/test_fused_tail.py (atol 2e-5, rtol
1e-5) and, for the Detector, those of tests/test_torch_port_detector.py.
"""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_port import YOLOV7_640_FUSED_TAILS, lively, min_score_gap
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.config.plan import cvt_cfg as jax_cvt_cfg
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu.kernels import fused_conv_pallas
from yolo_continuous_tpu.nn.builder import YoloModel as JaxModel
from yolo_continuous_tpu.nn.builder import build_model_spec as jax_spec
from yolo_continuous_tpu.nn.layers import Conv as JaxConv
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.kernels import fused_conv
from yolo_continuous_tpu_torch.nn import layers
from yolo_continuous_tpu_torch.ops.decode import decode_outputs
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax

TOL = dict(atol=2e-5, rtol=1e-5)


def _conv_pair(rs, c1, c2):
    """A JAX Conv's variables with random BN statistics, and the port Conv
    (fused and unfused) carrying the same values."""
    x = jnp.zeros((1, 4, 4, c1), jnp.float32)
    v = JaxConv(c2, 1, 1).init(jax.random.PRNGKey(0), x, False)
    params = jax.tree.map(np.asarray, v["params"])
    params["bn"]["bn"]["scale"] = (1.0 + 0.1 * rs.randn(c2)).astype(np.float32)
    params["bn"]["bn"]["bias"] = (0.1 * rs.randn(c2)).astype(np.float32)
    stats = {"bn": {"bn": {"mean": (0.1 * rs.randn(c2)).astype(np.float32),
                           "var": (rs.rand(c2) + 0.5).astype(np.float32)}}}
    sd = {"conv.weight": params["conv"]["kernel"].transpose(3, 2, 0, 1),
          "bn.weight": params["bn"]["bn"]["scale"], "bn.bias": params["bn"]["bn"]["bias"],
          "bn.running_mean": stats["bn"]["bn"]["mean"], "bn.running_var": stats["bn"]["bn"]["var"]}
    sd = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()}
    sd["bn.num_batches_tracked"] = torch.tensor(0)
    port = {}
    for fused in (False, True):
        port[fused] = layers.Conv(c1, c2, 1, 1, fused_tail=fused)
        port[fused].load_state_dict(sd, strict=True)
        port[fused].eval()
    return {"params": params, "batch_stats": stats}, port


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def test_fused_conv_matches_jax():
    rs = np.random.RandomState(0)
    variables, port = _conv_pair(rs, 512, 256)
    x = rs.rand(2, 8, 8, 512).astype(np.float32)
    assert JaxConv(256, 1, 1).fused_tail_min_cin == layers.FUSED_TAIL_MIN_CIN == 512
    ref = JaxConv(256, 1, 1, fused_tail=True).apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        ours = port[True](_nchw(x))
        unfused = port[False](_nchw(x))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(ours.numpy(), unfused.numpy(), **TOL)


def test_fused_conv_below_min_cin_and_in_training_is_the_unfused_branch():
    rs = np.random.RandomState(1)
    _, port = _conv_pair(rs, 64, 32)
    x = torch.from_numpy(rs.rand(2, 64, 8, 8).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(port[True](x), port[False](x))               # C_in 64 < 512
    _, port = _conv_pair(rs, 512, 64)
    x = torch.from_numpy(rs.rand(2, 512, 4, 4).astype(np.float32))
    port[True].train()
    port[False].train()
    with torch.no_grad():
        assert torch.equal(port[True](x), port[False](x))               # training mode


def test_fused_pointwise_conv_plain_matches_pallas_and_xla():
    """The plain version on NCHW against the JAX kernel (interpret mode) and
    its XLA oracle on NHWC, at a ragged shape (70 pixels), in fp32 and bf16."""
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, 7, 64).astype(np.float32)
    w = (rs.randn(64, 128) * 0.1).astype(np.float32)
    s = (rs.rand(128) + 0.5).astype(np.float32)
    b = (rs.randn(128) * 0.1).astype(np.float32)
    args = (torch.from_numpy(w.T.copy()), torch.from_numpy(s), torch.from_numpy(b))
    ours = fused_conv.fused_pointwise_conv(_nchw(x), *args)
    assert tuple(ours.shape) == (2, 128, 5, 7)
    pallas = fused_conv_pallas.fused_pointwise_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                                    jnp.asarray(b), block_m=128, interpret=True)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(pallas), **TOL)
    # bf16 in and out, fp32 accumulator and epilogue: within one bf16 ulp
    xb, wb = _nchw(x).bfloat16(), args[0].bfloat16()
    ours = fused_conv.fused_pointwise_conv(xb, wb, *args[1:])
    ref = fused_conv_pallas.xla_pointwise_conv(jnp.asarray(x, jnp.bfloat16),
                                               jnp.asarray(w, jnp.bfloat16), jnp.asarray(s),
                                               jnp.asarray(b))
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref, np.float32), rtol=8e-3, atol=1e-3)


def test_fused_conv_kernel_takes_cuda_tensors_only():
    x, w, v = torch.zeros(1, 8, 2, 2), torch.zeros(4, 8), torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.fused_pointwise_conv_cuda(x, w, v, v)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.launch_form(x.bfloat16(), w.bfloat16(), v, v, "wgmma")
    with pytest.raises(ValueError, match="CUDA .* or CPU"):
        fused_conv.fused_pointwise_conv(x.to("meta"), w, v, v)
    assert fused_conv.fused_pointwise_conv_cuda.launches == 0


# --- which form of K5 a call takes --------------------------------------------


def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")   # no storage, aligned


def test_form_for_takes_wgmma_for_every_main_path_call(monkeypatch):
    """The 24 eligible Convs of yolov7, traced at 64 px on the CPU: at 640 px
    (every map 10x wider) each call takes the TMA + wgmma form."""
    shapes = []
    fn = layers.fused_pointwise_conv
    monkeypatch.setattr(layers, "fused_pointwise_conv", lambda x, w, s, b: shapes.append(
        (x.shape[1], w.shape[0], 10 * x.shape[2], 10 * x.shape[3])) or fn(x, w, s, b))
    Detector(TrainPlan(_cfg()), device="cpu", fused_tails=True).forward(
        np.zeros((1, SIZE, SIZE, 3), np.float32))
    assert shapes == YOLOV7_640_FUSED_TAILS
    for c, n, h, w in shapes:
        assert fused_conv.form_for(_bf16(16, c, h, w), _bf16(n, c)) == "wgmma"


@pytest.mark.parametrize("c,h,w", [(520, 9, 15), (37, 8, 8), (1020, 20, 20), (512, 5, 7),
                                   (512, 1, 4)])
def test_form_for_takes_mma_sync_where_tma_cannot(c, h, w):
    """C or H*W not a multiple of 8: a row of the tensor map would not be a
    multiple of 16 bytes."""
    assert (c % 8, h * w % 8) != (0, 0)
    assert fused_conv.form_for(_bf16(2, c, h, w), _bf16(64, c)) == "mma_sync"


def test_form_for_takes_mma_sync_for_a_misaligned_pointer_and_fma_for_fp32():
    flat = torch.zeros(1 + 2 * 512 * 64, dtype=torch.bfloat16)
    x = flat[1:].view(2, 512, 8, 8)                       # 2 bytes past an aligned start
    w = torch.zeros(64, 512, dtype=torch.bfloat16)
    assert x.data_ptr() % 16 and fused_conv.form_for(x, w) == "mma_sync"
    assert fused_conv.form_for(flat[:-1].view(2, 512, 8, 8), w) == "wgmma"
    assert fused_conv.form_for(x.float(), w.float()) == "fma"


# --- the fused-tail Detector -------------------------------------------------

SIZE, CONF, IOU, MAX_DET = 64, 0.01, 0.45, 100
WEIGHT_SEED, HEAD_GAIN = 6, 16.0  # chosen so that the top-k scores are 1e-5 apart


def _cfg(net="cfg/net/yolov7.yaml", **kw):
    cfg = yaml.safe_load(open("cfg/chip_tiny.yaml"))
    cfg.update(image_size=SIZE, model_cfg=net, save_dir="/nonexistent/", **kw)
    return cfg


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("net,eligible", [("cfg/net/yolov7.yaml", 24),
                                          ("cfg/net/yolov7-tiny.yaml", 0)])
def test_eligible_convs(monkeypatch, net, eligible):
    """yolov7 has 24 eligible 1x1 SiLU Convs with C_in >= 512; yolov7-tiny's
    Convs are LeakyReLU, so none. The JAX model traces the same count (its
    eval-mode init, traced without compiling)."""
    ours = _count_calls(monkeypatch, layers, "fused_pointwise_conv")
    det = Detector(TrainPlan(_cfg(net)), device="cpu", fused_tails=True)
    det.forward(np.zeros((1, SIZE, SIZE, 3), np.float32))
    assert len(ours) == eligible
    plan = JaxPlan(_cfg(net))
    model = JaxModel(spec=jax_spec(jax_cvt_cfg(plan.model_cfg), plan.image_chan, plan.anchors,
                                   plan.num_labels, plan.anchors_mask), fused_tails=True)
    ref = _count_calls(monkeypatch, fused_conv_pallas, "fused_pointwise_conv")
    jax.eval_shape(lambda x: model.init(jax.random.PRNGKey(0), x, False),
                   jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    assert len(ref) == eligible


def test_fused_tails_defaults_to_the_plan_key():
    assert not Detector(TrainPlan(_cfg()), device="cpu").fused_tails
    assert Detector(TrainPlan(_cfg(fused_tails=True)), device="cpu").fused_tails
    assert not Detector(TrainPlan(_cfg(fused_tails=True)), device="cpu", fused_tails=False).fused_tails


def test_fused_tails_detector_matches_jax():
    cfg = _cfg()
    jax_det = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32)
    rs = np.random.RandomState(WEIGHT_SEED)
    params, stats = lively(jax_det.params, rs), lively(jax_det.batch_stats, rs)
    params["detect"] = {name: {k: v * HEAD_GAIN if k == "kernel" else v for k, v in conv.items()}
                        for name, conv in params["detect"].items()}
    jax_det = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32, params=params,
                          batch_stats=stats, fused_tails=True)
    det = Detector(TrainPlan(dict(cfg)), device="cpu", fused_tails=True,
                   state_dict=state_dict_from_jax(jax_det.spec, params, stats))

    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    with torch.no_grad():
        pred = decode_outputs(det.forward(x), det.spec.anchors, det.spec.strides)
    score = (pred[..., 4] * pred[..., 5:].max(-1).values).numpy()
    assert min_score_gap(np.where(score >= CONF, score, -1.0), MAX_DET) > 1e-5   # no top-k ties

    ours = [t.numpy() for t in det(x, CONF, IOU, MAX_DET)]
    ref = [np.asarray(t) for t in jax_det(jnp.asarray(x), CONF, IOU, MAX_DET)]
    valid = ref[3]
    np.testing.assert_array_equal(ours[3], valid)
    assert 0 < valid.sum(1).min() and valid.sum(1).max() < MAX_DET     # NMS dropped some
    np.testing.assert_allclose(ours[0][valid], ref[0][valid], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours[1][valid], ref[1][valid], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours[2][valid], ref[2][valid])
