"""int8 PTQ serving of the port (``nn/quant.py``, ``layers.Conv``,
``YoloModel(quant_mode=...)``, ``Detector(quantize=True)``) against the JAX
package's (``layers.py:85-112, 470-500``, ``detect_api.py:78-110, 199-226``).

- One Conv from the same numpy input, weights and amax: the int32
  accumulators bit-equal to JAX's integer convolution, the block's output
  within 1e-6 relative (BN and the activation in fp32, summation order).
- yolov7-tiny @64 (``cfg/chip_tiny.yaml``), ``lively`` weights: the amax of
  every Conv after ``calibrate`` equal to JAX's ``"quant"`` collection
  (carried across by ``tools/jax_weights.quant_state_from_jax``) to rtol 1e-5,
  over one batch and as a running max over two; the quantized maps within
  1e-2 relative L2 of JAX's quantized Detector's, and the top detection of
  each image the same class within 0.05 in box (JAX
  ``test_detector_quantized_end_to_end``'s bar).
- In train mode the mode changes nothing (bit-equal); int8 runs before the
  fused-tail branch; ``reload_weights`` keeps the scales and derives ``wq``
  from the fp32 weights of the new checkpoint.
"""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_port import ANCHORS, lively
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu.nn import layers as JL
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.nn import layers as L
from yolo_continuous_tpu_torch.nn import quant as Q
from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
from yolo_continuous_tpu_torch.tools.jax_weights import quant_state_from_jax, state_dict_from_jax

SIZE = 64


# ---------------------------------------------------------------- one Conv

def _jax_accumulators(x, kernel, amax, s, p, g):
    """The integer convolution of JAX ``layers.Conv``'s int8 branch
    (``layers.py:486-498``), on the same numpy inputs."""
    sx = jnp.maximum(amax, 1e-12) / 127.0
    xq = jnp.clip(jnp.round(jnp.asarray(x) / sx), -127, 127).astype(jnp.int8)
    sw = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)) / 127.0, 1e-12)
    wq = jnp.clip(jnp.round(kernel / sw), -127, 127).astype(jnp.int8)
    return np.asarray(jax.lax.conv_general_dilated(
        xq, wq, (s, s), [(p, p), (p, p)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=g, preferred_element_type=jnp.int32))


@pytest.mark.parametrize("c1,c2,k,s,g", [
    (8, 16, 1, 1, 1), (8, 16, 1, 2, 1), (8, 16, 3, 1, 1), (8, 16, 3, 2, 1),
    (3, 16, 3, 1, 1),            # the stem's C_in = 3 (K = 27)
    (16, 24, 3, 2, 4),           # grouped
    (16, 16, 3, 1, 16),          # depthwise (DWConv)
])
def test_conv_int8_matches_jax(c1, c2, k, s, g):
    rs = np.random.RandomState(c1 * 100 + k * 10 + s + g)
    x = (rs.randn(2, 12, 10, c1) * 1.5).astype(np.float32)
    jconv = JL.Conv(c2, k, s, None, g, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda a: jconv.init(jax.random.PRNGKey(0), a, False), x)
    params, stats = lively(shapes["params"], rs), lively(shapes["batch_stats"], rs)
    amax = np.float32(np.abs(x).max() * 0.8)            # some inputs clip at 127
    with JL.quant_ctx("int8"):
        want = np.asarray(jconv.apply({"params": params, "batch_stats": stats,
                                       "quant": {"amax": jnp.asarray(amax)}}, x, False))

    conv = L.Conv(c1, c2, k, s, None, g).eval()
    bn = conv.bn
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(params["conv"]["kernel"].transpose(3, 2, 0, 1)))
        bn.weight.copy_(torch.from_numpy(params["bn"]["bn"]["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bn"]["bn"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["bn"]["bn"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["bn"]["bn"]["var"]))
    conv.amax = torch.tensor(amax)
    conv.set_int8_weights(conv.conv.weight)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    acc = conv.int8_accumulators(xt, Q.activation_scale(conv.amax))
    np.testing.assert_array_equal(acc.numpy(), _jax_accumulators(
        x, params["conv"]["kernel"], amax, s, k // 2, g))
    assert np.abs(acc.numpy()).max() > 1000
    with torch.no_grad(), L.quant_ctx("int8"):
        got = conv(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_route_for_picks_by_shape_and_raises_past_int32():
    assert Q.route_for((2, 8, 16, 16), (16, 8, 3, 3), 1, 1, 1, "cpu") == "plain"
    assert Q.route_for((16, 64, 320, 320), (64, 64, 3, 3), 1, 1, 1) == "gemm"   # 0.94 GB
    assert Q.route_for((32, 64, 320, 320), (64, 64, 3, 3), 1, 1, 1) == "taps"   # 1.9 GB
    assert Q.route_for((4, 16, 8, 8), (16, 1, 3, 3), 1, 1, 16) == "f64"
    with pytest.raises(ValueError, match="overflow int32"):
        Q.route_for((1, 16000, 4, 4), (8, 16000, 3, 3), 1, 1, 1)
    with pytest.raises(ValueError, match="exceeds"):
        Q.route_for((512, 512, 320, 320), (64, 512, 3, 3), 1, 1, 1)


def test_gemm_weight_orders_taps_major():
    wq = torch.arange(2 * 3 * 3 * 3, dtype=torch.int8).reshape(2, 3, 3, 3)
    mat = Q.gemm_weight(wq)
    assert mat.shape == (8, 32) and not mat[2:].any() and not mat[:, 27:].any()
    assert mat[1, (2 * 3 + 1) * 3 + 2] == wq[1, 2, 2, 1]       # tap (dy 2, dx 1), channel 2


# ---------------------------------------------------------------- the Detector

def _cfg(tmp_dir):
    cfg = yaml.safe_load(open("cfg/chip_tiny.yaml"))
    cfg.update(image_size=SIZE, save_dir=str(tmp_dir) + "/")
    return cfg


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX and port Detectors with quantize=True and the same lively weights."""
    cfg = _cfg(tmp_path_factory.mktemp("runs"))
    plain = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32)
    rs = np.random.RandomState(3)
    params, stats = lively(plain.params, rs), lively(plain.batch_stats, rs)
    jax_det = JaxDetector(JaxPlan(dict(cfg)), dtype=jnp.float32, params=params,
                          batch_stats=stats, quantize=True)
    sd = state_dict_from_jax(jax_det.spec, params, stats)
    return jax_det, cfg, sd


def _images(seed, n=2, gain=1.0):
    return (np.random.RandomState(seed).rand(n, SIZE, SIZE, 3) * gain).astype(np.float32)


def _port(cfg, sd, **kw):
    return Detector(TrainPlan(dict(cfg)), device="cpu", state_dict=sd, quantize=True, **kw)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_calibrate_matches_jax_quant_collection(pair):
    jax_det, cfg, sd = pair
    det = _port(cfg, sd)
    small, big = _images(1, 1, 0.1), _images(2, 1)
    want_small = quant_state_from_jax(det.spec, jax.device_get(jax_det.calibrate(small)))
    got_small = det.calibrate(small)
    assert set(got_small) == set(want_small) and len(got_small) == len(det.model.quant_convs())
    for k in got_small:
        np.testing.assert_allclose(got_small[k].numpy(), want_small[k].numpy(), rtol=1e-5,
                                   err_msg=k)
    # a running max over two batches: the second accumulates onto the first
    want = quant_state_from_jax(det.spec, jax.device_get(jax_det.calibrate(big)))
    got = det.calibrate([big])
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, err_msg=k)
        assert got[k] >= got_small[k]
    assert any(got[k] > got_small[k] for k in got)


def test_quantized_detector_matches_jax(pair):
    jax_det, cfg, sd = pair
    det = _port(cfg, sd)
    x = _images(4)
    with pytest.raises(RuntimeError, match="calibrate"):
        det(x, 0.01, 0.5)
    det.calibrate(x)
    jax_det.calibrate(jnp.asarray(x))
    ref_maps = jax.jit(lambda v, a: jax_det.model.apply(v, a, False))(
        {"params": jax_det.params, "batch_stats": jax_det.batch_stats, "quant": jax_det.quant},
        jnp.asarray(x))
    maps = det.forward(x)
    for got, want in zip(maps, ref_maps[: det.nl]):
        assert _rel_l2(got.numpy(), np.asarray(want)) < 1e-2
    b, s, c, v = (t.numpy() for t in det(x, 0.01, 0.5))
    jb, js, jc, jv = (np.asarray(t) for t in jax_det(jnp.asarray(x), 0.01, 0.5))
    for i in range(2):
        assert v[i][0] and jv[i][0]
        assert c[i][0] == jc[i][0]
        np.testing.assert_allclose(b[i][0], jb[i][0], atol=0.05)
    assert Q.route_calls["plain"] > 0


def test_quant_ignored_in_training():
    cfg = yaml.safe_load(open("cfg/net/yolov7-tiny.yaml"))
    spec = build_model_spec(cfg, 3, ANCHORS, 2)
    m_fp = YoloModel(spec).init_weights(torch.Generator().manual_seed(0))
    m_q = YoloModel(spec, quant_mode="int8")
    m_q.load_state_dict(m_fp.state_dict())
    x = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(1))
    out_fp, out_q = m_fp.train()(x), m_q.train()(x)
    for a, b in zip(out_fp, out_q):
        assert torch.equal(a, b)
    for a, b in zip(m_fp.state_dict().values(), m_q.state_dict().values()):
        assert torch.equal(a, b)                          # the BN statistics moved alike
    with pytest.raises(ValueError):
        YoloModel(spec, quant_mode="int4")


def test_int8_runs_before_fused_tails():
    """A Conv eligible for K5 (1x1, C_in >= 512) takes the int8 branch."""
    net = {"depth_multiple": 1.0, "width_multiple": 1.0,
           "backbone": [[-1, 1, "Conv", [512, 3, 2]], [-1, 1, "Conv", [32, 1, 1]],
                        [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]]],
           "head": [[[1, 2, 3], 1, "Detect", ["nc", "anchors"]]]}
    spec = build_model_spec(net, 3, ANCHORS, 2)
    fused = YoloModel(spec, fused_tails=True, quant_mode="int8").eval()
    fused.init_weights(torch.Generator().manual_seed(0))
    plain = YoloModel(spec, quant_mode="int8").eval()
    plain.load_state_dict(fused.state_dict())
    assert fused.model[1].fused_tail and not plain.model[1].fused_tail
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    for m in (fused, plain):
        m.calibrate(x).set_int8_weights()
    calls = Q.route_calls["plain"]
    with torch.no_grad():
        got, want = fused(x), plain(x)
    assert Q.route_calls["plain"] - calls == 2 * len(fused.quant_convs())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_reload_keeps_scales_and_rebuilds_int8_weights_from_fp32(pair, tmp_path):
    """On a bf16 body, ``wq`` and ``sw`` come from the fp32 weights of each
    checkpoint, not from the bf16 copy served; the amax values stay."""
    _, cfg, sd = pair
    det = _port(cfg, sd, dtype=torch.bfloat16)
    conv = det.model.model[0]
    assert conv.conv.weight.dtype == torch.bfloat16
    wq, sw = Q.quantize_weight(sd["model.0.conv.weight"])
    assert torch.equal(conv.wq, wq) and torch.equal(conv.sw, sw)
    scales = det.calibrate(_images(5))
    new = {k: (v * 1.37 if k.endswith("conv.weight") else v) for k, v in sd.items()}
    torch.save(new, tmp_path / "w.pth")
    assert det.reload_weights(str(tmp_path / "w.msgpack"))
    for k, v in det.model.quant_state().items():
        assert torch.equal(v, scales[k])
    for name, m in det.model.quant_convs():
        wq, sw = Q.quantize_weight(new[f"{name}.conv.weight"])
        assert torch.equal(m.wq, wq) and torch.equal(m.sw, sw), name
    rounded = Q.quantize_weight(det.model.model[0].conv.weight.float())
    assert not torch.equal(rounded[1], det.model.model[0].sw)   # the bf16 copy differs
    b, s, c, v = det(_images(6), 0.01, 0.5)
    assert torch.isfinite(s).all() and v.any()
