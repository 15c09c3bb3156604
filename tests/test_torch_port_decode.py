"""PyTorch port decode (plain version of kernel K3) vs the JAX package's
XLA decode and its Pallas kernel in interpret mode, atol 1e-5."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_continuous_tpu.kernels.decode_pallas import decode_level_pallas
from yolo_continuous_tpu.ops import decode as jax_decode
from yolo_continuous_tpu_torch.kernels.decode import decode_outputs_cuda
from yolo_continuous_tpu_torch.nn.heads import head_view
from yolo_continuous_tpu_torch.ops.decode import decode_level, decode_outputs

ANCHORS = ((12.0, 16.0), (19.0, 36.0), (40.0, 28.0))
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
