"""PyTorch port vs JAX package: the native JPEG stager.

The port's ``data/native_loader.stage_batch_native`` on the CPU (cv2 decode
with the EXIF orientation ignored, as on the card, and the plain version of
``csrc/staging.cu``: the bilinear resize in torch fp32 in
``native/staging.cpp``'s operation order) against JAX's, which runs the C++ library
(``native/staging.cpp``, libjpeg) built here: tiles, metas and ``ok`` bit
for bit, on JPEGs the test writes (down- and up-scales, 133 x 65 at 640,
1 x 1, grayscale), a PNG named ``.jpg`` and a missing file (``ok`` False in
both). Where JAX's library does not build, those tests skip and say why.
The kernel itself runs only on the card (``tests/test_torch_port_cuda.py``).
"""
import numpy as np
import pytest
import torch

from _torch_port import jax_native_loader, write_staging_files
from yolo_continuous_tpu_torch.data import dataset as pds
from yolo_continuous_tpu_torch.data import native_loader
from yolo_continuous_tpu_torch.kernels import _build, staging

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_staging_files(tmp_path_factory.mktemp("staging"))


@pytest.fixture(scope="module")
def jax_stager():
    loader = jax_native_loader()
    if loader is None:
        pytest.skip("JAX's native/libstaging.so does not build here (make, g++ and the "
                    "libjpeg headers are needed)")
    return loader


@pytest.mark.parametrize("size", [64, 128, 640])
def test_plain_stager_matches_jax(files, jax_stager, size):
    jt, jm, jo = jax_stager.stage_batch_native(files, size, 128)
    pt, pm, po = native_loader.stage_batch_native(files, size, 128, device="cpu")
    assert pt.dtype == np.uint8 and pt.shape == (len(files), size, size, 3)
    assert pm.dtype == np.float32 and po.dtype == bool
    np.testing.assert_array_equal(po, jo)
    assert po.tolist() == [True] * (len(files) - 2) + [False, False]    # PNG, missing
    np.testing.assert_array_equal(pt[jo], jt[jo])
    np.testing.assert_array_equal(pm[jo], jm[jo])
    assert (pt[~po] == 128).all() and (pm[~po] == 0).all()


def test_the_geometry_is_fp32():
    """JAX's library computes r, nw and nh in fp32: 133 x 65 at 640 is 639
    wide, where Python's fp64 gives 640."""
    r, nw, nh, ox, oy = staging.letterbox_geometry(133, 65, 640)
    assert (nw, nh, ox, oy) == (639, 312, 0, 164) and r.dtype == np.float32
    assert int(133 * min(640 / 133, 640 / 65)) == 640
    assert staging.letterbox_geometry(1, 1, 64)[1:] == (64, 64, 0, 0)


def test_fp32_width_case_matches_jax(files, jax_stager):
    """The canvas of the 133 x 65 file: column 639 is fill in both."""
    i = [j for j, p in enumerate(files) if p.endswith("s4.jpg")]
    jt, _, _ = jax_stager.stage_batch_native([files[i[0]]], 640, 128)
    pt, pm, _ = native_loader.stage_batch_native([files[i[0]]], 640, 128, device="cpu")
    np.testing.assert_array_equal(pt, jt)
    assert (pt[0, :, 639] == 128).all() and pm[0].tolist()[:2] == [133, 65]


def test_round_half_away_from_zero():
    v = torch.tensor([0.0, 0.49999997, 0.5, 1.5, 2.5, 254.5, 254.49998, 255.00002])
    assert staging._round_half_away(v).tolist() == [0, 0, 1, 2, 3, 255, 254, 255]
    assert torch.round(torch.tensor([2.5])).item() == 2          # half to even, not lround


def test_plain_letterbox_of_a_fill_row(files):
    """A row with nw = 0 is a canvas of fill alone (a batch's unused mosaic
    slot); the others are the image's, on fill 128."""
    dec = staging.decode(staging.read_files(files[:1]), "cpu")
    geo = [staging.canvas_row(dec, 0, 32, 128)[0], staging.canvas_row(None, 0, 32, 0)[0]]
    out = staging.stage_letterbox(dec.src, torch.tensor(geo), 32)
    assert out.shape == (2, 32, 32, 3) and (out[1] == 0).all()
    assert (out[0, :8] == 128).all() and (out[0, 8:24] != 128).any()   # 200 x 100 -> 32 x 16
    assert staging.stage_letterbox.launches == 0                  # the CPU takes the plain version


def test_decode_refuses_what_libjpeg_refuses(files):
    data = staging.read_files(files)
    assert data[-1] is None                                       # missing
    dec = staging.decode(data, "cpu")
    assert dec.ok.tolist() == [True] * (len(files) - 2) + [False, False]   # PNG, missing
    assert dec.dims[0].tolist() == [200, 100] and dec.dims[-2:].tolist() == [[0, 0], [0, 0]]
    img = dec.src[dec.offsets[0]:dec.offsets[0] + 200 * 100 * 3].reshape(100, 200, 3).numpy()
    np.testing.assert_array_equal(img, cv2.cvtColor(cv2.imread(files[0]), cv2.COLOR_BGR2RGB))


def test_a_cuda_dataset_raises_when_the_stager_does_not_build(monkeypatch):
    """On the card the native stager is not optional: no quiet move to cv2."""
    def no_nvcc(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", no_nvcc)
    monkeypatch.setattr(_build, "build", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        pds.YoloDataset([], 64, device="cuda")
    assert pds.YoloDataset([], 64, device="cuda", use_native=False).use_native is False
    assert native_loader.available() is False and native_loader.ensure_built() is False


def test_use_native_defaults():
    assert pds.YoloDataset([], 64).use_native is False
    assert pds.YoloDataset([], 64, device="cpu").use_native is False
    assert pds.YoloDataset([], 64, use_native=True).use_native is True


def test_stage_letterbox_checks_its_cuda_inputs():
    """The wrapper's checks, without a card: meta tensors stand in."""
    src = torch.empty(10, dtype=torch.uint8, device="meta")
    geo = torch.empty((2, staging.GEO_COLS), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        staging._check(src, geo, 8, torch.empty((2, 8, 8, 3), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        staging.decode([b""], "meta")
