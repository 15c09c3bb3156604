"""PyTorch port IBin decode (plain version of kernel K4) vs the JAX package's
XLA ``decode_level_bin`` and its Pallas kernel in interpret mode, atol 1e-5.

The K4 wrapper's choice of form and its level table are pure Python and are
tested here too.

Inputs hold the argmax-gap precondition: the top two sigmoided bins of every
w/h value are more than 1e-5 apart, so exp() rounding cannot pick another
bin (``_torch_port.ibin_logits``, ``min_bin_gap``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import ibin_logits, min_bin_gap
from yolo_continuous_tpu.kernels.bin_decode_pallas import decode_level_bin_pallas
from yolo_continuous_tpu.ops import decode as jax_decode
from yolo_continuous_tpu.ops import sigmoid_bin as jax_sb
from yolo_continuous_tpu_torch.kernels.bin_decode import decode_outputs_bin_cuda, form_for
from yolo_continuous_tpu_torch.kernels.decode import level_table
from yolo_continuous_tpu_torch.nn.heads import head_view
from yolo_continuous_tpu_torch.ops import sigmoid_bin
from yolo_continuous_tpu_torch.ops.decode import decode_level_bin, decode_outputs_bin

ANCHORS = ((12.0, 16.0), (19.0, 36.0), (40.0, 28.0))
TOL = dict(rtol=1e-5, atol=1e-5)
NC = 3


def _pred(seed, lead=(2, 8, 6, 3)):
    p = ibin_logits(np.random.RandomState(seed), lead, NC)
    assert min_bin_gap(p) > 1e-5
    return p


def test_bins_and_constants_match_jax():
    for count, vmax in ((21, 4.0), (10, 1.0)):
        ours = sigmoid_bin.SigmoidBinCfg(bin_count=count, vmax=vmax)
        ref = jax_sb.SigmoidBinCfg(bin_count=count, vmax=vmax)
        assert (ours.length, ours.step, ours.scale) == (ref.length, ref.step, ref.scale)
        np.testing.assert_array_equal(ours.bins().numpy(), np.asarray(ref.bins()))


def test_sigmoid_bin_decode_matches_jax():
    cfg = sigmoid_bin.SigmoidBinCfg(bin_count=21, vmin=0.0, vmax=4.0)
    raw = ibin_logits(np.random.RandomState(0), (500,), 0)[:, 3:3 + cfg.length - 1]
    s = 1.0 / (1.0 + np.exp(-np.concatenate([np.random.RandomState(1).randn(500, 1), raw], 1)))
    s = s.astype(np.float32)
    ours = sigmoid_bin.sigmoid_bin_decode(torch.from_numpy(s), cfg)
    ref = jax_sb.sigmoid_bin_decode(jnp.asarray(s), jax_sb.SigmoidBinCfg(21, 0.0, 4.0))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_sigmoid_bin_decode_takes_the_first_maximum():
    """Saturated bins tie exactly; both packages then take the first one."""
    cfg = sigmoid_bin.SigmoidBinCfg(bin_count=21, vmin=0.0, vmax=4.0)
    s = np.full((2, 22), 0.25, np.float32)
    s[:, 0] = 0.5
    s[0, [4, 9]] = 1.0
    s[1, [17, 3]] = 1.0
    ours = sigmoid_bin.sigmoid_bin_decode(torch.from_numpy(s), cfg).numpy()
    ref = np.asarray(jax_sb.sigmoid_bin_decode(jnp.asarray(s), jax_sb.SigmoidBinCfg(21, 0.0, 4.0)))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_allclose(ours, cfg.bins().numpy()[[3, 2]], rtol=0, atol=1e-7)


# JAX's decode_level_bin compiled as one program, as the JAX Detector
# compiles it (inside ``_build_infer``). Called eagerly it runs op by op, and
# each op's executable is shared by its HLO with other tests (the normalized
# division's with JAX's ``decode_level`` of test_torch_port_decode.py) and,
# through the persistent cache (tests/.xla_cache), with other workers, which
# write it without an atomic rename; this program is built by this test alone.
_jax_decode_level_bin = jax.jit(jax_decode.decode_level_bin,
                                static_argnames=("stride", "bin_count", "normalized"))


@pytest.mark.parametrize("normalized", [True, False])
def test_decode_level_bin_matches_jax(normalized):
    p = _pred(0)
    ours = decode_level_bin(torch.from_numpy(p), torch.tensor(ANCHORS), 16.0, 21, normalized)
    ref = _jax_decode_level_bin(jnp.asarray(p), jnp.asarray(ANCHORS), stride=16.0, bin_count=21,
                                normalized=normalized)
    assert tuple(ours.shape) == (2, 8 * 6 * 3, 5 + NC)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("normalized", [True, False])
def test_decode_level_bin_matches_pallas_interpret(normalized):
    p = _pred(1, (2, 8, 8, 3))
    ours = decode_level_bin(torch.from_numpy(p), torch.tensor(ANCHORS), 32.0, 21, normalized)
    ref = decode_level_bin_pallas(jnp.asarray(p), ANCHORS, 32.0, 21, normalized, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_decode_outputs_bin_matches_jax():
    """Three levels in IBin head order (P3 first), as the Detector decodes them."""
    anchors = (ANCHORS, ((36.0, 75.0), (76.0, 55.0), (72.0, 146.0)),
               ((142.0, 110.0), (192.0, 243.0), (459.0, 401.0)))
    strides = (8, 16, 32)
    preds = [_pred(2 + i, (2, n, n, 3)) for i, n in enumerate((8, 4, 2))]
    ours = decode_outputs_bin([torch.from_numpy(p) for p in preds], anchors, strides)
    ref = jax_decode.decode_outputs_bin([jnp.asarray(p) for p in preds], anchors, strides)
    assert tuple(ours.shape) == (2, 3 * (64 + 16 + 4), 5 + NC)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_decode_of_strided_ibin_view_keeps_jax_rows():
    """The strided (bs, h, w, na, no) view of an NCHW IBin output decodes to
    the rows JAX gives for the NHWC map."""
    bs, na, h, w = 2, 3, 5, 4
    nhwc = _pred(6, (bs, h, w, na))
    no = nhwc.shape[-1]
    y = torch.from_numpy(nhwc.reshape(bs, h, w, na * no)).permute(0, 3, 1, 2).contiguous()
    view = head_view(y, na, no)
    assert not view.is_contiguous()
    ours = decode_outputs_bin([view], [ANCHORS], [8])
    ref = jax_decode.decode_level_bin(jnp.asarray(nhwc), jnp.asarray(ANCHORS), 8.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_bin_decode_kernel_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA"):
        decode_outputs_bin_cuda([torch.zeros(1, 2, 2, 3, 5 + 44)], [ANCHORS], [8])
    assert decode_outputs_bin_cuda.launches == 0


def test_bin_decode_dispatch_rejects_other_devices():
    with pytest.raises(ValueError, match="CUDA .* or CPU"):
        decode_outputs_bin([torch.zeros(1, 2, 2, 3, 49, device="meta")], [ANCHORS], [8])


# --- the K4 wrapper's forms and level table (no card needed) -----------------

IBIN_NO = 80 + 3 + 2 * 22        # 127 columns at 80 classes and 21 bins


def _ibin_maps(sides, bs=2, na=3, no=IBIN_NO):
    """Head views of NCHW IBin outputs, P3 first (uninitialised)."""
    return [head_view(torch.empty(bs, na * no, h, w), na, no) for h, w in sides]


@pytest.mark.parametrize("size", [640, 64])
def test_form_for_takes_tma_for_the_yolov7_ibin_head_views(size):
    assert form_for(_ibin_maps([(size // s, size // s) for s in (8, 16, 32)])) == "tma"


@pytest.mark.parametrize("case", ["h*w % 4", "channels-last", "contiguous", "offset base",
                                  "5 levels"])
def test_ibin_form_for_takes_strided_where_tma_cannot(case):
    if case == "h*w % 4":
        maps = _ibin_maps([(8, 8), (3, 3)])
    elif case == "channels-last":
        y = torch.empty(2, 3 * IBIN_NO, 4, 4).to(memory_format=torch.channels_last)
        maps = [head_view(y, 3, IBIN_NO)]
    elif case == "contiguous":
        maps = [m.contiguous() for m in _ibin_maps([(4, 4)])]
    elif case == "offset base":
        flat = torch.empty(2 + 2 * 3 * IBIN_NO * 16)
        maps = [head_view(flat[2:].view(2, 3 * IBIN_NO, 4, 4), 3, IBIN_NO)]
    else:
        maps = _ibin_maps([(2, 2)] * 5)
    assert form_for(maps) == "strided"


def test_ibin_level_table_is_p3_first_with_pixel_anchors():
    anchors = (ANCHORS, ((36.0, 75.0), (76.0, 55.0), (72.0, 146.0)),
               ((142.0, 110.0), (192.0, 243.0), (459.0, 401.0)))
    table = level_table(_ibin_maps([(80, 80), (40, 40), (20, 20)]), anchors, (8, 16, 32),
                        feature_units=False)
    assert [lv.row0 for lv in table] == [0, 19200, 24000]
    assert [lv.anchors for lv in table] == [tuple(v for pair in a for v in pair) for a in anchors]


def test_a_four_level_ibin_input_takes_tma():
    maps = _ibin_maps([(160, 160), (80, 80), (40, 40), (20, 20)], bs=1)
    assert form_for(maps) == "tma"


@pytest.mark.parametrize("nc,form", [(80, "tma"), (125, "tma"), (126, "strided")])
def test_ibin_form_for_at_the_edge_of_shared_memory(nc, form):
    """K4 stages nc + 47 input columns and writes nc + 5: with 3 anchors its
    block fits in 227 KB up to 125 classes."""
    assert form_for(_ibin_maps([(8, 8), (4, 4)], no=nc + 3 + 2 * 22)) == form
