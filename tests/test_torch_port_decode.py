"""PyTorch port decode (plain version of kernel K3) vs the JAX package's
XLA decode and its Pallas kernel in interpret mode, atol 1e-5; and the K3
wrapper's choice of form and its level table, which are pure Python."""
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_continuous_tpu.kernels.decode_pallas import decode_level_pallas
from yolo_continuous_tpu.ops import decode as jax_decode
from yolo_continuous_tpu_torch.kernels import decode as k3
from yolo_continuous_tpu_torch.kernels.decode import decode_outputs_cuda, form_for, level_table
from yolo_continuous_tpu_torch.nn.heads import head_view
from yolo_continuous_tpu_torch.ops.decode import decode_level, decode_outputs

ANCHORS = ((12.0, 16.0), (19.0, 36.0), (40.0, 28.0))
# yolov7's anchors by level, P3 first
YOLOV7_ANCHORS = (ANCHORS, ((36.0, 75.0), (76.0, 55.0), (72.0, 146.0)),
                  ((142.0, 110.0), (192.0, 243.0), (459.0, 401.0)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _pred(seed, shape=(2, 8, 6, 3, 7)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3.0


@pytest.mark.parametrize("normalized", [True, False])
def test_decode_level_matches_jax(normalized):
    p = _pred(0)
    ours = decode_level(torch.from_numpy(p), torch.tensor(ANCHORS), 32.0, normalized)
    ref = jax_decode.decode_level(jnp.asarray(p), jnp.asarray(ANCHORS), 32.0, normalized)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("normalized", [True, False])
def test_decode_level_matches_pallas_interpret(normalized):
    p = _pred(1)
    ours = decode_level(torch.from_numpy(p), torch.tensor(ANCHORS), 16.0, normalized)
    ref = decode_level_pallas(jnp.asarray(p), ANCHORS, 16.0, normalized, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_decode_outputs_matches_jax():
    """Three levels in head order (P5 first), as the Detector decodes them."""
    anchors = (((142.0, 110.0), (192.0, 243.0), (459.0, 401.0)),
               ((36.0, 75.0), (76.0, 55.0), (72.0, 146.0)), ANCHORS)
    strides = (32, 16, 8)
    preds = [_pred(2 + i, (2, n, n, 3, 9)) for i, n in enumerate((2, 4, 8))]
    ours = decode_outputs([torch.from_numpy(p) for p in preds], anchors, strides)
    ref = jax_decode.decode_outputs([jnp.asarray(p) for p in preds], anchors, strides)
    assert tuple(ours.shape) == (2, 3 * (4 + 16 + 64), 9)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_decode_of_strided_head_view_keeps_jax_rows():
    """Regression (candidate order): decoding the strided (bs, h, w, na, no)
    view of an NCHW conv output gives the rows JAX gives for the NHWC map."""
    bs, na, no, h, w = 2, 3, 7, 5, 4
    y = torch.from_numpy(np.random.RandomState(5).randn(bs, na * no, h, w).astype(np.float32))
    view = head_view(y, na, no)
    assert not view.is_contiguous()
    ours = decode_outputs([view], [ANCHORS], [8])
    nhwc = y.permute(0, 2, 3, 1).numpy().reshape(bs, h, w, na, no)
    ref = jax_decode.decode_level(jnp.asarray(nhwc), jnp.asarray(ANCHORS), 8.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_decode_kernel_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA"):
        decode_outputs_cuda([torch.zeros(1, 2, 2, 3, 7)], [ANCHORS], [8])
    assert decode_outputs_cuda.launches == 0


def test_decode_dispatch_rejects_other_devices():
    with pytest.raises(ValueError, match="CUDA .* or CPU"):
        decode_outputs([torch.zeros(1, 2, 2, 3, 7, device="meta")], [ANCHORS], [8])


# --- the K3 wrapper's forms and level table (no card needed) -----------------

def _maps(sides, bs=2, na=3, no=85):
    """Head views of NCHW outputs, as Detect gives them (uninitialised)."""
    return [head_view(torch.empty(bs, na * no, h, w), na, no) for h, w in sides]


@pytest.mark.parametrize("size", [640, 64])
def test_form_for_takes_tma_for_the_yolov7_head_views(size):
    """Detect's P5, P4, P3 maps at 640 px (20, 40, 80) and 64 px (2, 4, 8)."""
    maps = _maps([(size // s, size // s) for s in (32, 16, 8)])
    assert form_for(maps) == "tma"


def _channels_last(bs=2, na=3, no=9, h=4, w=4):
    y = torch.empty(bs, na * no, h, w).to(memory_format=torch.channels_last)
    return head_view(y, na, no)


def _offset_base(floats, bs=2, na=3, no=9, h=4, w=4):
    flat = torch.empty(floats + bs * na * no * h * w)
    return head_view(flat[floats:].view(bs, na * no, h, w), na, no)


@pytest.mark.parametrize("case", ["h*w % 4", "channels-last", "contiguous", "offset base",
                                  "5 levels"])
def test_form_for_takes_strided_where_tma_cannot(case):
    if case == "h*w % 4":
        maps = _maps([(4, 4), (5, 7)], no=9)
    elif case == "channels-last":
        maps = [_channels_last()]
        assert maps[0].shape == (2, 4, 4, 3, 9)
    elif case == "contiguous":
        maps = [m.contiguous() for m in _maps([(4, 4)], no=9)]
    elif case == "offset base":
        maps = [_offset_base(1)]
        assert maps[0].data_ptr() % 16 == 4
    else:
        maps = _maps([(2, 2)] * 5, no=9)
    assert form_for(maps) == "strided"


def test_form_for_takes_tma_for_a_base_offset_by_16_bytes():
    assert form_for([_offset_base(4)]) == "tma"


def test_level_table_row_offsets_follow_the_head_order():
    """Detect lists P5 first; an I-head lists P3 first. The table keeps the
    order it is given."""
    detect = level_table(_maps([(20, 20), (40, 40), (80, 80)]), YOLOV7_ANCHORS[::-1], (32, 16, 8))
    assert [lv.row0 for lv in detect] == [0, 1200, 6000]
    assert [(lv.h, lv.w, lv.na, lv.stride) for lv in detect] == [
        (20, 20, 3, 32.0), (40, 40, 3, 16.0), (80, 80, 3, 8.0)]
    ibin = level_table(_maps([(80, 80), (40, 40), (20, 20)]), YOLOV7_ANCHORS, (8, 16, 32))
    assert [lv.row0 for lv in ibin] == [0, 19200, 24000]


def test_level_table_points_at_each_map():
    maps = _maps([(2, 2), (4, 4)], no=9)
    assert [lv.ptr for lv in level_table(maps, YOLOV7_ANCHORS[:2], (32, 16))] == [
        m.data_ptr() for m in maps]


@pytest.mark.parametrize("feature_units", [True, False])
def test_level_table_anchors_round_as_the_plain_version(feature_units):
    """K3 takes anchors in feature units, pixels / stride in fp32, bit for bit
    what ``decode_level`` computes; K4 takes them in pixels."""
    strides = (32, 16, 8)
    table = level_table(_maps([(20, 20), (40, 40), (80, 80)]), YOLOV7_ANCHORS[::-1], strides,
                        feature_units)
    for lv, a, s in zip(table, YOLOV7_ANCHORS[::-1], strides):
        want = torch.tensor(a, dtype=torch.float32)
        if feature_units:
            want = want / s
        assert torch.equal(torch.tensor(lv.anchors, dtype=torch.float32), want.flatten())


def test_a_four_level_p6_table_takes_tma():
    """A P6 net at 1280 px: P3 ... P6 maps of 160 ... 20 cells a side."""
    maps = _maps([(160, 160), (80, 80), (40, 40), (20, 20)], bs=1)
    anchors = YOLOV7_ANCHORS + (((436.0, 615.0), (739.0, 380.0), (925.0, 792.0)),)
    assert form_for(maps) == "tma"
    table = level_table(maps, anchors, (8, 16, 32, 64))
    assert [lv.row0 for lv in table] == [0, 76800, 96000, 100800]


def test_form_for_takes_strided_where_a_tile_outgrows_shared_memory():
    """A box row of more than 256 columns, or a block whose two input stages
    and two output runs of 32 pixels pass 227 KB, is not what the TMA form
    stages."""
    assert form_for(_maps([(4, 4)], na=1, no=260)) == "strided"
    assert form_for(_maps([(4, 4)], na=3, no=255)) == "strided"
    assert form_for(_maps([(4, 4)], na=2, no=255)) == "strided"      # 261296 bytes
    assert form_for(_maps([(4, 4)], na=3, no=155)) == "strided"      # 238256 bytes


# (na, no): the widest head that fits for na anchors, and one column more
SMEM_EDGES = [(3, 151, "tma"), (3, 152, "strided"), (2, 226, "tma"), (2, 227, "strided"),
              (1, 256, "tma")]


@pytest.mark.parametrize("na,no,form", SMEM_EDGES)
def test_form_for_at_the_edge_of_shared_memory(na, no, form):
    """176 + 512 na no bytes when no_out = no (both roundings are exact):
    na = 3 fits up to 151 columns (80 classes give 85)."""
    assert k3.tma_smem_bytes(na, no, no) == 176 + 512 * na * no
    assert form_for(_maps([(8, 8), (4, 4)], na=na, no=no)) == form


def test_form_for_sizes_the_block_by_the_most_anchors_of_any_level():
    """The kernel stages every tile at the most anchors of any level."""
    one = head_view(torch.empty(2, 1 * 152, 8, 8), 1, 152)
    three = head_view(torch.empty(2, 3 * 152, 4, 4), 3, 152)
    assert form_for([one]) == "tma" and form_for([one, three]) == "strided"


def test_the_wrapper_constants_are_the_kernels():
    """MAX_TMA_LEVELS, TILE_PIXELS and TMA_SMEM_BYTES copy kMaxLevels, kP
    and kSmemPerBlock of csrc/decode_tma.cuh; tma_smem_bytes copies its
    smem_bytes at 2 stages."""
    src = (pathlib.Path(k3.__file__).parent.parent / "csrc" / "decode_tma.cuh").read_text()

    def const(name):
        return eval(re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1))

    assert (const("kMaxLevels"), const("kP"), const("kSmemPerBlock")) == (
        k3.MAX_TMA_LEVELS, k3.TILE_PIXELS, k3.TMA_SMEM_BYTES)
    assert ("return 128 + static_cast<size_t>(stages) * lv.stage_bytes + 2 * out_floats * 4 "
            "+ 8 * stages;") in src
    assert "+ 127u) & ~127u;" in src and "+ 4u + 3u) & ~3u;" in src
