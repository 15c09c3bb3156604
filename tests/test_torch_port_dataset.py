"""PyTorch port vs JAX package: the host data pipeline.

The port's ``YoloDataset`` against JAX's on a small temp dataset (JPEGs
written with cv2, mixed aspect ratios, 0-6 boxes): ``batch``,
``batch_plan``, ``staged_pool``, ``n_tiles`` and the epoch order bit-equal
over two epochs with the per-epoch reseed: with cv2 staging in both, and
with ``use_native=True`` in both (JAX's C++ library, the port's plain
version of its stager, with a grayscale JPEG and a PNG named ``.jpg`` that
falls back to cv2), where JAX's library builds. The port's
``PrefetchLoader`` raises a worker's exception in the consumer, where JAX's
ends the epoch early. ``prepare_test_image`` equals JAX's on
``resource/horses.jpg``.
"""
import threading

import numpy as np
import pytest

from _torch_port import jax_native_loader, write_dataset
from yolo_continuous_tpu.data import dataset as jds
from yolo_continuous_tpu_torch.data import dataset as pds
from yolo_continuous_tpu_torch.ops import preprocess

cv2 = pytest.importorskip("cv2")
SIZE, MB, BS = 64, 8, 3


@pytest.fixture(scope="module")
def ann(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("ds"), 7, seed=0)


def _pair(ann, use_native=False, **kw):
    args = dict(image_size=SIZE, max_boxes=MB, mosaic=True, mixup=True, mosaic_prob=0.7,
                mixup_prob=0.5, epoch_length=2, special_aug_ratio=0.5, seed=5, **kw)
    return (jds.YoloDataset(jds.load_annotation_file(ann), use_native=use_native, **args),
            pds.YoloDataset(pds.load_annotation_file(ann), use_native=use_native or None,
                            **args))


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_annotations_parse_as_jax(ann):
    lines = open(ann).readlines() + ["", "/c.jpg"]
    for a, b in zip(jds.parse_annotation_lines(lines), pds.parse_annotation_lines(lines)):
        assert a.path == b.path
        _equal([a.boxes], [b.boxes])


def test_stage_image_matches_jax():
    from yolo_continuous_tpu.ops import preprocess as jpre
    rs = np.random.RandomState(1)
    for h, w in ((30, 50), (64, 64), (90, 40)):
        img = rs.randint(0, 255, (h, w, 3), np.uint8)
        (jc, jm), (pc, pm) = jpre.stage_image(img, SIZE), preprocess.stage_image(img, SIZE)
        np.testing.assert_array_equal(jc, pc)
        assert jm.__dict__ == pm.__dict__
    boxes = rs.rand(4, 5).astype(np.float32) * 50
    np.testing.assert_array_equal(jpre.letterbox_boxes(boxes, (0.5, 0.7), (3.0, 1.5)),
                                  preprocess.letterbox_boxes(boxes, (0.5, 0.7), (3.0, 1.5)))


@pytest.mark.parametrize("size", [(640, 640), (320, 256)])
def test_prepare_test_image_matches_jax(size):
    from yolo_continuous_tpu.ops import preprocess as jpre
    (jd, ji), (pd, pi) = (jpre.prepare_test_image("resource/horses.jpg", size),
                          preprocess.prepare_test_image("resource/horses.jpg", size))
    assert pd.dtype == np.float32 and pd.shape == (1, size[1], size[0], 3)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pi, ji)


def _two_epochs(j, p):
    """Two epochs of batches and plans, then single calls, equal in both."""
    for epoch in range(2):
        j.reseed(epoch)
        p.reseed(epoch)
        assert j.n_tiles == p.n_tiles == (4 if epoch == 0 else 1)
        jb = list(j.epoch_batches(BS, shuffle=True, drop_last=False))
        pb = list(p.epoch_batches(BS, shuffle=True, drop_last=False))
        assert len(jb) == len(pb) == -(-len(j) // BS)     # the last batch wraps
        for a, b in zip(jb, pb):
            _equal(a, b)
        assert j.epoch_now == p.epoch_now == epoch + 1
        j.reseed(epoch)
        p.reseed(epoch)
        for a, b in zip(j.epoch_plans(BS, True, True), p.epoch_plans(BS, True, True)):
            _equal(a, b)
    j.reseed(0)
    p.reseed(0)
    _equal(j.batch_plan([0, 3, 6]), p.batch_plan([0, 3, 6]))
    _equal(j.batch([1, 2]), p.batch([1, 2]))
    _equal(j.staged_pool(), p.staged_pool())


def test_dataset_matches_jax_over_two_epochs(ann):
    j, p = _pair(ann)
    assert len(j) == 7 and not p.use_native
    _two_epochs(j, p)


@pytest.fixture(scope="module")
def native_ann(tmp_path_factory):
    """The dataset plus a grayscale JPEG and a PNG named ``.jpg``, which the
    native stagers refuse and stage with cv2."""
    root = tmp_path_factory.mktemp("native")
    ann = write_dataset(root, 7, seed=0)
    rs = np.random.RandomState(1)
    cv2.imwrite(str(root / "gray.jpg"), rs.randint(0, 255, (40, 60), np.uint8))
    cv2.imwrite(str(root / "p.png"), rs.randint(0, 255, (50, 30, 3), np.uint8))
    (root / "p.png").rename(root / "png.jpg")
    with open(ann, "a") as f:
        f.write(f"{root / 'gray.jpg'} 1,1,20,20,0\n{root / 'png.jpg'} 2,2,10,10,1\n")
    return ann


@pytest.fixture(scope="module")
def jax_native():
    if jax_native_loader() is None:
        pytest.skip("JAX's native/libstaging.so does not build here (make, g++ and the "
                    "libjpeg headers are needed)")


@pytest.mark.parametrize("cache", [False, True])
def test_native_dataset_matches_jax_over_two_epochs(native_ann, jax_native, cache, monkeypatch):
    """``use_native=True`` in both: JAX's C++ stager and the port's plain one
    on the CPU give the same batches, pools and cv2 fallbacks. The port's
    cache holds the decoded pixels of the files that decode, and a second
    pass reads only the file that does not (the PNG, staged by cv2)."""
    from yolo_continuous_tpu_torch.kernels import staging
    j, p = _pair(native_ann, use_native=True, cache_images=cache)
    assert j.use_native and p.use_native and len(p) == 9
    _two_epochs(j, p)
    if cache:                       # a second pass reads the cache
        _equal(j.batch(list(range(9))), p.batch(list(range(9))))
        assert sorted(p._decoded) == sorted(a.path for a in p.annotations[:8])
        read, reads = staging.read_files, []
        monkeypatch.setattr(staging, "read_files", lambda paths: reads.extend(paths) or read(paths))
        _equal(j.batch([0, 7, 8]), p.batch([0, 7, 8]))
        assert set(reads) <= {p.annotations[8].path}


def test_native_staged_pool_matches_jax(native_ann, jax_native, monkeypatch):
    """The pool through the native stager, in chunks of POOL_CHUNK images."""
    monkeypatch.setattr(pds, "POOL_CHUNK", 4)
    j, p = _pair(native_ann, use_native=True)
    _equal(j.staged_pool(), p.staged_pool())


def test_cached_images_match_jax(ann):
    j, p = _pair(ann, cache_images=True)
    for _ in range(2):       # the second pass reads the cache
        _equal(j.batch([0, 1, 2]), p.batch([0, 1, 2]))


# the JAX loader's worker thread dies of the exception, which pytest reports
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_prefetch_loader_raises_a_worker_exception(ann, tmp_path):
    anns = pds.load_annotation_file(ann)
    anns[4].path = str(tmp_path / "missing.jpg")
    ds = pds.YoloDataset(anns, SIZE, MB, mosaic=False, seed=0)
    got = []
    with pytest.raises(FileNotFoundError, match="missing.jpg"):
        for batch in pds.PrefetchLoader(lambda: ds.epoch_batches(2, shuffle=False)):
            got.append(batch)
    assert len(got) == 2                          # the batches before the one that failed
    # the JAX loader ends the epoch there without a word
    jd = jds.YoloDataset(jds.load_annotation_file(ann), SIZE, MB, mosaic=False, seed=0,
                         use_native=False)
    jd.annotations[4].path = anns[4].path
    before = set(threading.enumerate())
    assert len(list(jds.PrefetchLoader(lambda: jd.epoch_batches(2, shuffle=False)))) == 2
    for t in set(threading.enumerate()) - before:
        t.join(timeout=10)


def test_prefetch_loader_stops_its_worker_when_the_consumer_stops():
    before = set(threading.enumerate())
    loader = pds.PrefetchLoader(lambda: iter(range(1000)), depth=2)
    it = iter(loader)
    assert [next(it), next(it)] == [0, 1]
    (worker,) = set(threading.enumerate()) - before
    it.close()
    worker.join(timeout=10)
    assert not worker.is_alive()
