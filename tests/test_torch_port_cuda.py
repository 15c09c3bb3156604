"""Kernels K1, K2, K3 on the card against their plain PyTorch versions.

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

from yolo_continuous_tpu_torch.kernels.decode import decode_outputs_cuda
from yolo_continuous_tpu_torch.kernels.nms import nms_suppress, nms_suppress_tiled
from yolo_continuous_tpu_torch.nn.heads import head_view
from yolo_continuous_tpu_torch.ops.decode import decode_level
from yolo_continuous_tpu_torch.ops.nms import suppress, suppress_plain

pytestmark = pytest.mark.cuda
ANCHORS = (((142.0, 110.0), (192.0, 243.0), (459.0, 401.0)),
           ((36.0, 75.0), (76.0, 55.0), (72.0, 146.0)),
           ((12.0, 16.0), (19.0, 36.0), (40.0, 28.0)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    return torch.device("cuda")


@pytest.mark.parametrize("normalized", [True, False])
def test_decode_kernel_matches_plain(cuda, normalized):
    g = torch.Generator(device=cuda).manual_seed(0)
    maps = [head_view(torch.randn(3, 3 * 9, n, n + 1, device=cuda, generator=g) * 3, 3, 9)
            for n in (3, 5, 9)]
    strides = (32, 16, 8)
    before = decode_outputs_cuda.launches
    got = decode_outputs_cuda(maps, ANCHORS, strides, normalized)
    torch.cuda.synchronize()
    assert decode_outputs_cuda.launches == before + 3
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


@pytest.mark.parametrize("kernel,k", [(nms_suppress, 300), (nms_suppress, 1024),
                                      (nms_suppress_tiled, 1500), (nms_suppress_tiled, 4096)])
def test_nms_kernels_match_plain(cuda, kernel, k):
    args = _boxes(np.random.RandomState(k), 3, k, 3)
    got = kernel(*args, 0.45)
    torch.cuda.synchronize()
    want = suppress_plain(*args, 0.45)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(args[2].sum())


def test_suppress_dispatches_by_k(cuda):
    rs = np.random.RandomState(0)
    n1, n2 = nms_suppress.launches, nms_suppress_tiled.launches
    suppress(*_boxes(rs, 2, 1024, 3), 0.45)
    suppress(*_boxes(rs, 2, 1025, 3), 0.45)
    assert (nms_suppress.launches - n1, nms_suppress_tiled.launches - n2) == (1, 1)
