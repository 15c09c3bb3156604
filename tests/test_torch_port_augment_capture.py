"""The compiled augmentation (``Trainer.jitted_augment``), on the CPU.

JAX jits ``augment_batch`` and ``augment_batch_from_pool`` with ``cfg``,
``max_gt`` and ``train`` static. On CUDA the port's ``Trainer`` replays one
captured CUDA graph per key: the source (pool or tiles), train or eval, the
AugConfig, ``max_gt`` and the layout of the graph's one small input, the
flat fp32 vector of the draw record (whose mosaic rows number n, the
flagged samples) with the metas, boxes and masks or the tile indices. The
graphs share one memory pool and one static tile buffer a shape.

Here the Trainer's compiled route is forced on the CPU and ``CapturedCall``
is replaced by ``CpuGraph`` (``test_torch_port_capture.py``'s pattern: the
real copy-in, count and clone around a "graph" whose replay runs the
captured function again), so that the captured function (the record
rebuilt from the flat vector inside it) is held bit for bit to the eager
``Trainer.augment`` (the record sent by ``BatchDraw.to``), whose parity
with JAX's ``augment_batch`` is ``test_torch_port_augment.py``'s; and
``Trainer.run`` through the compiled augmentation to ``run`` through the
eager one (its parity with JAX's is ``test_torch_port_train_run.py``'s).
Batches of 4 at 64 px, max_boxes 8, a tiny Detect net.
"""
import numpy as np
import pytest
import torch

from _torch_port import tiny_plan_cfg, write_dataset
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.ops.augment import (AugConfig, _leaves, draw_batch, flat_record,
                                                   record_from_flat, record_layout)
from yolo_continuous_tpu_torch.train import train_loop
from yolo_continuous_tpu_torch.train.train_loop import Trainer
from yolo_continuous_tpu_torch.utils import capture
from yolo_continuous_tpu_torch.utils.capture import CapturedCall

B, S, MB = 4, 64, 8
ALL_ON = AugConfig(size=S, copy_paste=0.5, flip_ud=0.5, equalize=0.5, use_perspective=True,
                   degrees=10.0, translate=0.1, pscale=0.1, shear=10.0)


class CpuGraph(CapturedCall):
    """``CapturedCall`` with its graph replaced, for CPU tensors; it keeps the
    static input buffers it is handed and the pool it is given."""

    made = []

    def __init__(self, fn, *examples, pool=None, inputs=None, outputs=None):
        capture._not_nested(type(self).__name__)
        self._inputs = tuple(inputs) if inputs is not None else tuple(x.clone()
                                                                       for x in examples)
        self._copy_in(examples)
        self.pool = pool
        if outputs is not None:         # as the warm-up shows the shapes
            with capture._Recording([]):
                warm = fn(*self._inputs)
            fn = capture.copied_into(fn, capture.shared_buffers(outputs, warm))
        record = []
        with capture._Recording(record):
            outs = fn(*self._inputs)
        self._single = isinstance(outs, torch.Tensor)
        self._outputs = (outs,) if self._single else tuple(outs)
        self._record = capture._merge(record)
        self.launches = {capture._label(t, k): n for t, k, n in self._record}
        self.graph, self._fn, self.replays = self, fn, 0
        CpuGraph.made.append(self)

    @staticmethod
    def new_pool():
        return object()

    def replay(self):
        with capture._Recording([]):
            outs = self._fn(*self._inputs)
        for static, new in zip(self._outputs, outs):
            static.copy_(new)
        self.replays += 1


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def graphs(monkeypatch):
    CpuGraph.made = []
    monkeypatch.setattr(train_loop, "CapturedCall", CpuGraph)
    return CpuGraph


def _trainer(cfg=ALL_ON):
    tr = Trainer(TrainPlan(dict(tiny_plan_cfg("Detect", S), max_boxes=MB)), device="cpu")
    tr.aug_cfg = cfg
    return tr


def _inputs(n, T, seed=0):
    """Staging canvases, metas, boxes (0-6 a tile) and masks, numpy."""
    rs = np.random.RandomState(seed)
    tiles = rs.randint(0, 255, (n, T, S, S, 3)).astype(np.uint8)
    metas = np.zeros((n, T, 5), np.float32)
    boxes = np.zeros((n, T, MB, 5), np.float32)
    masks = np.zeros((n, T, MB), bool)
    for b in range(n):
        for t in range(T):
            iw, ih = rs.randint(30, 100), rs.randint(30, 100)
            r = min(S / iw, S / ih)
            metas[b, t] = [iw, ih, r, (S - int(iw * r)) // 2, (S - int(ih * r)) // 2]
            for i in range(rs.randint(0, 7)):
                bw, bh = rs.uniform(6, iw / 2), rs.uniform(6, ih / 2)
                x, y = rs.uniform(0, iw - bw), rs.uniform(0, ih - bh)
                boxes[b, t, i] = [x, y, x + bw, y + bh, rs.randint(3)]
                masks[b, t, i] = True
    return tiles, metas, boxes, masks


def _flags(n_mosaic, seed=0):
    rs = np.random.RandomState(seed)
    mosaic = np.zeros(B, bool)
    mosaic[rs.permutation(B)[:n_mosaic]] = True
    return mosaic, rs.rand(B) < 0.5


def _batch(source, T, n_mosaic, seed=0):
    """A tiles batch (``YoloDataset.batch``) or, with its pool, an index
    batch (``epoch_plans``)."""
    mosaic, mixup = _flags(n_mosaic, seed)
    if source == "tiles":
        return _inputs(B, T, seed) + (mosaic, mixup), None
    pool = tuple(torch.from_numpy(a[:, 0]) for a in _inputs(6, 1, seed))
    idx = np.random.RandomState(seed + 1).randint(0, 6, (B, T)).astype(np.int32)
    return (idx, mosaic, mixup), pool


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


CASES = {  # name: source, T, mosaic count n, train
    "tiles T=1": ("tiles", 1, 0, True),
    "tiles T=4 n=0": ("tiles", 4, 0, True),
    "tiles T=4 n=2": ("tiles", 4, 2, True),
    "tiles T=4 n=B": ("tiles", 4, B, True),
    "pool T=4 n=3": ("pool", 4, 3, True),
    "pool T=1": ("pool", 1, 0, True),
    "tiles eval": ("tiles", 1, 0, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_flat_route_equals_the_record_route(graphs, case):
    """The captured function (the record rebuilt from the flat vector inside
    it), at its capture and at a replay, equals the eager augmentation bit
    for bit: images, labels and mask, every op on (copy-paste, UD flip,
    equalize, the perspective), the mosaic on n = 0, some and all samples."""
    source, T, n, train = CASES[case]
    tr = _trainer()
    batch, pool = _batch(source, T, n, seed=len(case))
    draw = tr.draw(3, T, *batch[-2:]) if train else None
    if draw is not None and T == 4:
        assert len(draw.mosaic_idx) == n
    want = tr.augment(draw, batch, train, pool=pool)
    assert want[2].any()
    for _ in range(2):
        _equal(tr._replayed_augment(draw, batch, train, pool=pool), want)
    assert len(graphs.made) == 1 and graphs.made[0].replays == 2


def test_a_record_survives_its_flat_vector():
    """``flat_record`` and ``record_from_flat`` give back every tensor of a
    draw record with its dtype, None where a part is absent; the layout keys
    the record's structure."""
    mosaic, mixup = _flags(2)
    for T, cfg in ((4, ALL_ON), (1, AugConfig(size=S))):
        rec = (draw_batch(torch.Generator().manual_seed(1), cfg, B, T, MB, mosaic, mixup),
               torch.arange(6, dtype=torch.int32).reshape(2, 3))
        back = record_from_flat(flat_record(rec), record_layout(rec))
        assert type(back[0]) is type(rec[0]) and record_layout(back) == record_layout(rec)
        assert (back[0].mosaic is None) == (T == 1)
        assert (back[0].post.perspective is None) == (not cfg.use_perspective)
        for a, b in zip(_leaves(rec), _leaves(back)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="fp64"):
        flat_record((torch.zeros(2, dtype=torch.float64),))


def test_one_capture_per_key_in_one_shared_pool(graphs):
    """A graph per mosaic count n (not per which samples are flagged), per
    mode, source, T and draw structure (the perspective's draws exist only
    when it is on); a repeated key replays. All of a Trainer's graphs share
    one pool, per tile shape one static tile buffer and one set of static
    outputs; another Trainer has its own pool."""
    tr = _trainer()
    calls = [("tiles", 4, 2, True, 0), ("tiles", 4, 2, True, 1),   # other samples, same n
             ("tiles", 4, 3, True, 2), ("tiles", 1, 0, True, 3), ("tiles", 1, 0, False, 4),
             ("pool", 4, 2, True, 5), ("tiles", 4, 3, True, 6)]
    made = []
    for source, T, n, train, seed in calls:
        batch, pool = _batch(source, T, n, seed)
        draw = tr.draw(seed, T, *batch[-2:]) if train else None
        _equal(tr._replayed_augment(draw, batch, train, pool=pool),
               tr.augment(draw, batch, train, pool=pool))
        made.append(len(graphs.made))
    assert made == [1, 1, 2, 3, 4, 5, 5]
    tr.aug_cfg = ALL_ON._replace(use_perspective=False)
    batch, _ = _batch("tiles", 4, 2)
    draw = tr.draw(9, 4, *batch[-2:])
    assert draw.post.perspective is None
    _equal(tr._replayed_augment(draw, batch), tr.augment(draw, batch))
    assert len(graphs.made) == 6 == len(tr._aug_graphs)
    assert len({id(g.pool) for g in graphs.made}) == 1 and graphs.made[0].pool is not None
    tiles_bufs = {g._inputs[1].shape: g._inputs[1] for g in graphs.made if len(g._inputs) == 2}
    for g in graphs.made:
        if len(g._inputs) == 2:
            assert g._inputs[1] is tiles_bufs[g._inputs[1].shape]
    assert len(tiles_bufs) == 2 and len(tr._aug_inputs) == 2      # T = 4 and T = 1
    # one set of static outputs (images, labels, mask) for every graph of B = 4,
    # and each call's results are clones of them
    assert len(tr._aug_outputs) == 3
    for i in range(3):
        assert len({id(g._outputs[i]) for g in graphs.made}) == 1
    out = tr._replayed_augment(draw, batch)
    assert all(o.data_ptr() != g.data_ptr() for o, g in zip(out, graphs.made[0]._outputs))
    other = _trainer(tr.aug_cfg)
    other._replayed_augment(draw, batch)
    assert graphs.made[-1].pool is not graphs.made[0].pool


def test_init_state_and_a_new_device_pool_drop_the_graphs(graphs):
    """``init_state`` drops every augmentation graph, their pool and buffers;
    a pool-path call with another device pool drops the graphs that read the
    old one, and keeps the tiles' graphs."""
    tr = _trainer()
    batch, pool = _batch("pool", 4, 2)
    draw = tr.draw(0, 4, *batch[-2:])
    tr._replayed_augment(draw, batch, pool=pool)
    tiles_batch, _ = _batch("tiles", 4, 1)
    tr._replayed_augment(tr.draw(1, 4, *tiles_batch[-2:]), tiles_batch)
    assert len(tr._aug_graphs) == 2 and tr._aug_source is pool
    old_pool_graph = graphs.made[0]
    new_pool = tuple(t.clone() for t in pool)
    new_pool[0][:] = 255 - new_pool[0]
    _equal(tr._replayed_augment(draw, batch, pool=new_pool), tr.augment(draw, batch,
                                                                        pool=new_pool))
    assert len(tr._aug_graphs) == 2 and tr._aug_source is new_pool and len(graphs.made) == 3
    assert old_pool_graph not in tr._aug_graphs.values() and graphs.made[1] in \
        tr._aug_graphs.values()
    tr.init_state(seed=0)
    assert tr._aug_graphs == {} and tr._aug_pool is None
    assert tr._aug_inputs == {} and tr._aug_outputs == {}
    assert tr._aug_source is None


@pytest.mark.parametrize("device_cache", [True, False])
def test_run_through_the_compiled_augmentation(graphs, monkeypatch, tmp_path, device_cache):
    """``Trainer.run`` with ``jitted_augment()`` taking the compiled route
    (the train step stays eager on the CPU) ends with the state of a run
    through the eager augmentation, bit for bit; it augmented the train
    batches (pool or tiles) and the val batches (eval mode) through graphs,
    and dropped them at its end."""
    pytest.importorskip("cv2")
    ann = write_dataset(tmp_path, 4, seed=7)
    cfg = dict(tiny_plan_cfg("Detect", S), train=ann, val=ann, epochs=1, batch_size=2,
               max_boxes=MB, save_dir=str(tmp_path) + "/", enhance=True, mosaic_prob=0.7,
               mixup_prob=0.5, device_cache=device_cache, seed=3)
    eager = Trainer(TrainPlan(dict(cfg, save_name="eager")), device="cpu")
    want = eager.run(log=lambda *_: None)
    assert eager.jitted_augment() == eager.augment
    routes = []
    replayed = Trainer._replayed_augment

    def spy(self, draw, batch, train=True, pool=None):
        routes.append((train, pool is not None))
        return replayed(self, draw, batch, train, pool=pool)

    monkeypatch.setattr(Trainer, "_replayed_augment", spy)
    monkeypatch.setattr(Trainer, "jitted_augment", lambda self: self._replayed_augment)
    tr = Trainer(TrainPlan(dict(cfg, save_name="compiled")), device="cpu")
    got = tr.run(log=lambda *_: None)
    assert sorted(set(routes)) == sorted({(True, device_cache), (False, False)})
    assert len(graphs.made) >= 2 and tr._aug_graphs == {} and tr._aug_source is None
    assert got["step"] == want["step"] == 2
    a, b = got["model"].state_dict(), want["model"].state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert [s["loss"] for s in tr.epoch_stats] == [s["loss"] for s in eager.epoch_stats]


def test_a_failed_capture_raises_and_the_next_takes_a_new_pool(graphs, monkeypatch):
    """A capture that fails raises ``CaptureError`` and keeps no graph;
    nothing runs in its place. PyTorch leaves a failed capture's pool
    recording, so the Trainer gives that pool up and the next capture
    takes a new one."""
    from yolo_continuous_tpu_torch.utils.capture import CaptureError
    tr = _trainer()
    batch, _ = _batch("tiles", 4, 2)
    draw = tr.draw(0, 4, *batch[-2:])
    tr._replayed_augment(draw, batch)
    first_pool = tr._aug_pool

    class Failing(CpuGraph):
        def __init__(self, *a, **kw):
            raise CaptureError("capture failed")

    monkeypatch.setattr(train_loop, "CapturedCall", Failing)
    with pytest.raises(CaptureError):
        tr._replayed_augment(draw, batch, False)
    assert tr._aug_pool is None and len(tr._aug_graphs) == 1
    monkeypatch.setattr(train_loop, "CapturedCall", CpuGraph)
    _equal(tr._replayed_augment(draw, batch, False), tr.augment(draw, batch, False))
    assert tr._aug_pool is not None and tr._aug_pool is not first_pool
