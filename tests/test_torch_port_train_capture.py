"""The compiled train step on the CPU: JAX's ``jitted_train_step`` and
``jitted_eval_loss`` against the port's, the optimizer's device scalars and
zero buffers, earlier checkpoints, and the cache of captured steps.

On CUDA ``Trainer.jitted_train_step()`` replays one
``utils/capture.CapturedStep`` per input shape and dtype (its first call is
the warm-up and a real step), and ``jitted_eval_loss()`` one
``CapturedCall``. On the CPU both are the eager functions, held here to
JAX's compiled ones at ``tests/test_torch_port_train.py``'s tolerances:
the shallow IAuxDetect net over three steps of the warm-up ramp (lr_w, lr_b
and mom all change), yolov7-tiny @64 over one (``CASES``). The cache logic runs
with the graph replaced by ``CpuStep`` (and ``CpuGraph`` of
``test_torch_port_capture.py`` for the eval loss): the real ``__call__``
and its first call, the graph's capture and replay re-run on the CPU. Their
bit-equality with the eager step on the card is in
``tests/test_torch_port_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import lively, tiny_plan_cfg
from test_torch_port_capture import CpuGraph
from test_torch_port_train import CONFIGS, _batch, _rel_l2
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.ops import schedules as jax_schedules
from yolo_continuous_tpu.train.ema import ema_init
from yolo_continuous_tpu.train.optimizer import Optimizer as JaxOptimizer
from yolo_continuous_tpu.train.train_loop import Trainer as JaxTrainer
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.ops.schedules import LRSchedule
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax
from yolo_continuous_tpu_torch.train import train_loop
from yolo_continuous_tpu_torch.train.checkpoint import save_checkpoint, try_load
from yolo_continuous_tpu_torch.train.optimizer import GROUPS, label_params, make_optimizer
from yolo_continuous_tpu_torch.train.train_loop import Trainer
from yolo_continuous_tpu_torch.utils.capture import CapturedStep

PARTS = ("loss", "box", "obj", "cls")


def _ramp(n):
    """Steps 1..n of the warm-up ramp of ``LRSchedule`` (n + 1 warm-up steps
    in one epoch), where lr_w, lr_b and mom all change every step."""
    sched = LRSchedule(0.01, 0.1, 10, "Linear", 0.937, True, 1, n + 1, 0.8, 0.1, n + 1)
    hypers = [(h.lr_weights, h.lr_bias, h.momentum) for h in map(sched, range(1, n + 1))]
    for a, b in zip(hypers, hypers[1:]):
        assert all(x != y for x, y in zip(a, b))
    return hypers


# (net, steps): the shallow IAuxDetect net over three steps of the ramp at
# its tight tolerances; yolov7-tiny over one step at its loose ones. Past
# one step the deep net leaves them: the first step's gap (the BN sums'
# order) moves SimOTA's assignment by the third (num_fg 24 against 22 on
# these inputs), with ``torch.optim``'s step as with this optimizer.
CASES = {"iaux": 3, "yolov7-tiny": 1}


@pytest.fixture(scope="module", params=sorted(CASES))
def ramp_steps(request):
    """JAX's ``jitted_train_step`` and the port's compiled entry on the CPU,
    from the same lively weights, one batch a step, on the ramp's
    hyper-parameters."""
    name, n = request.param, CASES[request.param]
    cfg = CONFIGS[name]()
    jt = JaxTrainer(JaxPlan(dict(cfg)), dtype=jnp.float32)
    st = jt.init_state(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    params, stats = lively(st["params"], rs), lively(st["batch_stats"], rs)
    st = dict(st, params=params, batch_stats=stats, opt=jt.optimizer.init(params),
              ema=ema_init({"params": params, "batch_stats": stats}))
    batches = [_batch(len(cfg["labels"]), seed) for seed in range(2, 2 + n)]
    hypers = _ramp(n)
    jax_step, jax_parts = jt.jitted_train_step(), []
    for b, h in zip(batches, hypers):
        st, m = jax_step(st, *map(jnp.asarray, b), *h)
        jax_parts.append({k: float(v) for k, v in m.items()})
    tr = Trainer(TrainPlan(dict(cfg)), device="cpu")
    state = tr.init_state(state_dict=state_dict_from_jax(tr.spec, params, stats))
    old = {k: v.clone() for k, v in state["model"].state_dict().items()}
    step, parts = tr.jitted_train_step(), []
    for b, h in zip(batches, hypers):
        state, m = step(state, *b, *h)
        parts.append({k: float(v) for k, v in m.items()})
    spec = tr.spec
    return dict(name=name, steps=n, tr=tr, state=state, old=old, parts=parts,
                jax_parts=jax_parts, cfg=cfg, params=params, stats=stats, batches=batches,
                want=state_dict_from_jax(spec, st["params"], st["batch_stats"]),
                momentum=state_dict_from_jax(spec, st["opt"].momentum_buf, {}),
                ema=state_dict_from_jax(spec, st["ema"].tree["params"],
                                        st["ema"].tree["batch_stats"]))


def _close(got, want, keys, rtol, atol):
    for k in keys:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol, atol=atol(w), err_msg=k)


def test_compiled_step_on_the_cpu_is_the_eager_step_equal_to_jax(ramp_steps):
    """The tolerances of test_torch_port_train.py: IAuxDetect loss parts rtol
    1e-5, updates and momentum rtol 1e-3 with atol 1e-5 x the largest, BN
    statistics and EMA rtol 1e-5 with atol 2e-5 x the tensor's largest;
    yolov7-tiny loss parts rtol 1e-3, updates and momentum within 3e-2
    relative L2, BN statistics and EMA within 1e-2 of the tensor's largest."""
    s = ramp_steps
    tr, state, shallow = s["tr"], s["state"], s["name"] == "iaux"
    assert tr.jitted_train_step() == tr.train_step
    for p, j in zip(s["parts"], s["jax_parts"]):
        assert p["num_fg"] == j["num_fg"] > 0
        for k in PARTS:
            np.testing.assert_allclose(p[k], j[k], rtol=1e-5 if shallow else 1e-3, err_msg=k)
    assert state["step"] == state["ema"].updates == s["steps"]
    named = dict(state["model"].named_parameters())
    got = state["model"].state_dict()
    upd = {n: got[n] - s["old"][n] for n in named}
    want = {n: s["want"][n] - s["old"][n] for n in named}
    bufs = {n: state["opt"].state[p]["momentum_buffer"] for n, p in named.items()}
    stats = [k for k in s["want"] if k.endswith(("running_mean", "running_var"))]
    ema = state["ema"]
    if shallow:
        for a, b in ((upd, want), (bufs, s["momentum"])):
            biggest = max(float(v.abs().max()) for v in b.values() if v.numel())
            _close(a, b, named, 1e-3, lambda w: 1e-5 * biggest)
        _close(got, s["want"], stats, 1e-5, lambda w: 2e-5 * np.abs(w).max())
        _close(ema.tree, s["ema"], list(ema.tree), 1e-5, lambda w: 2e-5 * np.abs(w).max())
        return
    assert _rel_l2(upd, want, named) <= 3e-2
    assert _rel_l2(bufs, s["momentum"], named) <= 3e-2
    for tree, ref, keys in ((got, s["want"], stats), (ema.tree, s["ema"], list(ema.tree))):
        for k in keys:
            w = ref[k].numpy()
            assert np.abs(tree[k].numpy() - w).max() <= 1e-2 * np.abs(w).max(), k


def test_compiled_eval_loss_on_the_cpu_is_eval_loss_equal_to_jax(ramp_steps):
    """The eval loss (running BN statistics) of the weights before the steps,
    JAX's ``jitted_eval_loss``: rtol 1e-5 (IAuxDetect), 1e-3 (yolov7-tiny),
    the loss parts' tolerances."""
    s = ramp_steps
    tr = s["tr"]
    assert tr.jitted_eval_loss() == tr.eval_loss
    jt = JaxTrainer(JaxPlan(dict(s["cfg"])), dtype=jnp.float32)
    want = float(jt.jitted_eval_loss()(s["params"], s["stats"],
                                       *map(jnp.asarray, s["batches"][0])))
    fresh = tr.init_state(state_dict=state_dict_from_jax(tr.spec, s["params"], s["stats"]))
    got = float(tr.jitted_eval_loss()(fresh, *s["batches"][0]))
    np.testing.assert_allclose(got, want, rtol=1e-5 if s["name"] == "iaux" else 1e-3)


# ---------------------------------------------------------------- optimizer

def _model_and_plan(adam):
    tr = Trainer(TrainPlan(dict(tiny_plan_cfg("IAuxDetect", 64), adam=adam)), device="cpu")
    tr.init_state(seed=1)
    return tr.model, tr.plan


def _grads(model, seed):
    rs = np.random.RandomState(seed)
    return {n: torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("adam", [False, True])
def test_zero_buffers_give_jaxs_first_step(adam):
    """The buffers exist as zeros before any step (JAX's ``init``), so the
    first step takes the branch of every step: SGD's buffer is then the
    decayed gradient bit for bit (0 m + g = g), Adam's first moment
    (1 - m) g; the parameters are JAX's first step's (rtol 1e-6, Adam 2e-5 on
    the update, as test_optimizer_steps_match_jax)."""
    model, plan = _model_and_plan(adam)
    opt = make_optimizer(plan, model)
    keys = ("exp_avg", "exp_avg_sq") if adam else ("momentum_buffer",)
    named = dict(model.named_parameters())
    for p in named.values():
        assert all(torch.equal(opt.state[p][k], torch.zeros_like(p)) for k in keys)
    grads, old = _grads(model, 0), {n: p.detach().clone() for n, p in named.items()}
    for n, p in named.items():
        p.grad = grads[n].clone()
    lr_w, lr_b, mom = 0.01, 0.1, 0.8
    opt.step(torch.tensor([lr_w, lr_b, mom]))
    labels = label_params(model)
    jopt = JaxOptimizer(adam=adam, weight_decay=plan.weight_decay)
    for n, p in named.items():
        g = torch.add(grads[n], old[n], alpha=plan.weight_decay if labels[n] == "weight" else 0)
        if adam:
            assert torch.equal(opt.state[p]["exp_avg"], g * (1.0 - torch.tensor(mom)))
        else:
            assert torch.equal(opt.state[p]["momentum_buffer"], g)
        jp, _ = jopt.update({"x": jnp.asarray(grads[n].numpy())},
                            jopt.init({"x": jnp.asarray(old[n].numpy())}),
                            {"x": jnp.asarray(old[n].numpy())}, {"x": labels[n]},
                            jax_schedules.StepHyper(lr_weights=lr_w, lr_bias=lr_b, momentum=mom))
        want = np.asarray(jp["x"]) - old[n].numpy()
        np.testing.assert_allclose((p.detach() - old[n]).numpy(), want,
                                   rtol=2e-5 if adam else 1e-6, atol=1e-9, err_msg=n)


def _torch_optim(model, plan, adam):
    """The optimizer that earlier versions of the port made: torch.optim over
    the same groups."""
    labels = label_params(model)
    groups = [dict(params=[p for n, p in model.named_parameters() if labels[n] == g], label=g,
                   weight_decay=plan.weight_decay if g == "weight" else 0.0) for g in GROUPS]
    if adam:
        return torch.optim.Adam(groups, lr=0.0, betas=(0.937, 0.999), eps=1e-8, foreach=True)
    return torch.optim.SGD(groups, lr=0.0, momentum=0.937, nesterov=True, foreach=True)


@pytest.mark.parametrize("adam", [False, True])
@pytest.mark.parametrize("steps", [0, 2])
def test_an_earlier_optimizer_state_dict_loads_in_place(adam, steps, tmp_path):
    """A checkpoint whose optimizer is torch.optim's (earlier versions of the
    port), saved after ``steps`` steps (none: an empty state), loads through
    ``try_load`` into the buffers made at construction (their addresses
    stay, as a captured step reads them), with torch.optim's values (zeros
    for an empty state); a step then runs."""
    tr = Trainer(TrainPlan(dict(tiny_plan_cfg("IAuxDetect", 64), adam=adam)), device="cpu")
    state = tr.init_state(seed=1)
    old_opt = _torch_optim(state["model"], tr.plan, adam)
    named = dict(state["model"].named_parameters())
    for s in range(steps):
        for n, g in _grads(state["model"], s).items():
            named[n].grad = g
        for group in old_opt.param_groups:
            group["lr"] = 0.01
        old_opt.step()
    blob = {"model": state["model"].state_dict(), "opt": old_opt.state_dict(),
            "ema": state["ema"].state_dict(), "step": steps}
    path = str(tmp_path / "old.train.pt")
    torch.save(blob, path)
    fresh = tr.init_state(seed=5)
    addresses = {(i, k): v.data_ptr() for i, p in enumerate(named.values())
                 for k, v in fresh["opt"].state[p].items()}
    assert try_load(path, fresh) is fresh and fresh["step"] == steps
    for i, p in enumerate(named.values()):
        for k, v in fresh["opt"].state[p].items():
            assert v.data_ptr() == addresses[(i, k)], k
            if steps:
                assert torch.equal(v, old_opt.state[p][k].to(v.dtype)), k
            else:
                assert not v.any(), k
    _, parts = tr.train_step(fresh, *_batch(2), 0.01, 0.1, 0.9)
    assert np.isfinite(float(parts["loss"]))


# ---------------------------------------------------------------- the cache

class CpuStep(CapturedStep):
    """``CapturedStep`` with its graph replaced, for CPU tensors: the first
    call runs the real warm-up (a step); the "capture" keeps clones of its
    outputs as the static outputs, and a replay runs the function again and
    copies its results into them, as a replay writes the same addresses."""

    made = []

    def __init__(self, fn, *examples):
        self._inputs = tuple(torch.empty_like(x) for x in examples)
        self._fn, self.graph, self._error = fn, None, None
        self.replays = 0
        CpuStep.made.append(self)

    def _warm_up_and_capture(self, fn, device):
        outs = fn(*self._inputs)
        self._set_outputs({k: v.clone() for k, v in outs.items()})
        self._record, self.launches, self.graph, self._captured = [], {}, self, fn
        return outs

    def replay(self):
        for static, new in zip(self._outputs, self._captured(*self._inputs).values()):
            static.copy_(new)
        self.replays += 1


@pytest.fixture
def recorder(monkeypatch):
    CpuStep.made, CpuGraph.made = [], []
    monkeypatch.setattr(train_loop, "CapturedStep", CpuStep)
    monkeypatch.setattr(train_loop, "CapturedCall", CpuGraph)
    return CpuStep


def _pair(seed=0):
    """Two trainers of the same plan and weights: one for the replays, one
    eager, each with its state."""
    cfg = tiny_plan_cfg("IAuxDetect", 64)
    out = []
    for _ in range(2):
        tr = Trainer(TrainPlan(dict(cfg)), device="cpu")
        out += [tr, tr.init_state(seed=seed)]
    return out


def _equal_states(a, b):
    for k, v in a["model"].state_dict().items():
        assert torch.equal(b["model"].state_dict()[k], v), k
    for k, v in a["ema"].tree.items():
        assert torch.equal(b["ema"].tree[k], v), k
    sa, sb = a["opt"].state_dict()["state"], b["opt"].state_dict()["state"]
    for i, st in sa.items():
        assert all(torch.equal(v, sb[i][k]) for k, v in st.items()), i
    assert (a["step"], a["ema"].updates) == (b["step"], b["ema"].updates)


def _step_both(pair, batch, hyper):
    tr, state, eager, estate = pair
    _, got = tr._replayed_step(state, *batch, *hyper)
    _, want = eager.train_step(estate, *batch, *hyper)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    _equal_states(state, estate)


def _bf16(batch):
    return (torch.from_numpy(batch[0]).to(torch.bfloat16),) + tuple(batch[1:])


def test_one_capture_per_shape_and_dtype(recorder):
    """The first call of a shape is the warm-up and a real step; later calls
    replay. A partial last batch and bf16 images each take a graph of their
    own. Every call equals the eager step bit for bit, state included."""
    pair = _pair()
    tr = pair[0]
    full, part = _batch(2, 7), tuple(a[:1] for a in _batch(2, 8))
    hypers = _ramp(7)
    _step_both(pair, full, hypers[0])
    assert len(recorder.made) == 1 and recorder.made[0].replays == 0
    _step_both(pair, full, hypers[1])
    assert recorder.made[0].replays == 1
    _step_both(pair, part, hypers[2])
    _step_both(pair, _bf16(full), hypers[3])
    assert len(recorder.made) == 3
    _step_both(pair, part, hypers[4])
    _step_both(pair, _bf16(full), hypers[5])
    _step_both(pair, full, hypers[6])
    assert [c.replays for c in recorder.made] == [2, 1, 1]
    assert {k[1][0] for k in tr._graphs} == {(2, 64, 64, 3), (1, 64, 64, 3)}
    assert {k[1][1] for k in tr._graphs} == {torch.float32, torch.bfloat16}


def test_eval_loss_captures_once_per_shape(recorder):
    pair = _pair()
    tr, state, eager, estate = pair
    for batch, n in ((_batch(2, 1), 1), (_batch(2, 2), 1), (tuple(a[:1] for a in _batch(2, 3)), 2)):
        got = tr._replayed_eval_loss(state, *batch)
        assert torch.equal(got, eager.eval_loss(estate, *batch))
        assert len(CpuGraph.made) == n


def test_init_state_and_warm_start_drop_the_graphs_and_try_load_keeps_them(recorder,
                                                                           tmp_path):
    """``init_state`` and ``warm_start`` make a new optimizer and EMA: the
    graphs go, and the next call captures anew. ``try_load`` loads in place:
    the graphs stay, and the next replay trains from the loaded state as the
    eager step does. A call with another state dict drops them too."""
    pair = _pair()
    tr, state, eager, estate = pair
    batch, hypers = _batch(2, 4), _ramp(7)
    _step_both(pair, batch, hypers[0])
    tr._replayed_eval_loss(state, *batch)
    path = str(tmp_path / "a.train.pt")
    save_checkpoint(path, state)
    _step_both(pair, batch, hypers[1])
    assert try_load(path, state) is state and try_load(path, estate) is estate
    assert len(tr._graphs) == 2
    _step_both(pair, batch, hypers[2])
    assert len(recorder.made) == 1 and recorder.made[0].replays == 2

    pair[1] = state = tr.init_state(seed=3)
    pair[3] = estate = eager.init_state(seed=3)
    assert tr._graphs == {}
    _step_both(pair, batch, hypers[3])
    assert len(recorder.made) == 2
    torch.save(state["model"].state_dict(), str(tmp_path / "w.pth"))
    pair[1] = state = tr.warm_start(str(tmp_path / "w.pth"), state, log=lambda *_: None)
    pair[3] = estate = eager.warm_start(str(tmp_path / "w.pth"), estate, log=lambda *_: None)
    assert tr._graphs == {}
    _step_both(pair, batch, hypers[4])
    assert len(recorder.made) == 3
    other = dict(state)
    tr._replayed_step(other, *batch, *hypers[5])
    assert len(recorder.made) == 4 and tr._graph_state is other


def test_a_failed_capture_raises_and_runs_nothing_after(recorder):
    """A capture that fails raises ``CaptureError`` at the first call (whose
    warm-up ran its step); every later call of the key raises it again and
    leaves the state as it was."""
    from yolo_continuous_tpu_torch.utils.capture import CaptureError

    class Failing(CpuStep):
        def _warm_up_and_capture(self, fn, device):
            fn(*self._inputs)
            raise CaptureError("capture refused")

    tr, state = _pair()[:2]
    train_loop.CapturedStep = Failing
    batch = _batch(2, 5)
    with pytest.raises(CaptureError, match="refused"):
        tr._replayed_step(state, *batch, 0.01, 0.1, 0.9)
    before = {k: v.clone() for k, v in state["model"].state_dict().items()}
    with pytest.raises(CaptureError, match="refused"):
        tr._replayed_step(state, *batch, 0.01, 0.1, 0.9)
    for k, v in before.items():
        assert torch.equal(state["model"].state_dict()[k], v), k


def test_a_mesh_trainer_takes_the_eager_step(tmp_path, monkeypatch):
    """The rule, read from the mesh's backend before any launch: on CUDA the
    compiled step and eval loss replay graphs without a mesh and over NCCL
    groups, which a graph holds with their collectives; over gloo, whose
    collectives run on the host, they are ``train_step`` and ``eval_loss``.
    Here a world-of-one gloo mesh, its device then taken for CUDA, and its
    group's backend then read as NCCL; the eager functions it returns
    train and evaluate."""
    from yolo_continuous_tpu_torch.parallel import distributed as D
    from yolo_continuous_tpu_torch.parallel import mesh as M
    cfg = tiny_plan_cfg("IAuxDetect", 64)
    plain = Trainer(TrainPlan(dict(cfg)), device="cpu")
    D.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu", timeout_s=30)
    try:
        meshed = Trainer(TrainPlan(dict(cfg)), device="cpu", mesh=M.make_mesh(1, 1))
        state = M.shard_params(meshed.mesh, meshed.init_state(seed=0))
        assert meshed.jitted_train_step() == meshed.train_step
        assert meshed.jitted_eval_loss() == meshed.eval_loss
        for tr in (plain, meshed):
            monkeypatch.setattr(tr, "device", torch.device("cuda"))
        assert plain.jitted_train_step() == plain._replayed_step
        assert plain.jitted_eval_loss() == plain._replayed_eval_loss
        assert torch.distributed.get_backend(meshed.mesh.data_group) == "gloo"
        assert meshed.jitted_train_step() == meshed.train_step
        assert meshed.jitted_eval_loss() == meshed.eval_loss
        asked = []
        monkeypatch.setattr(torch.distributed, "get_backend",
                            lambda group=None: asked.append(group) or "nccl")
        assert meshed.jitted_train_step() == meshed._replayed_step
        assert meshed.jitted_eval_loss() == meshed._replayed_eval_loss
        assert asked == [meshed.mesh.data_group] * 2
        monkeypatch.undo()
        batch = M.shard_batch(meshed.mesh, _batch(2))
        loss = meshed.jitted_eval_loss()(state, *batch)
        assert torch.equal(loss, plain.eval_loss(plain.init_state(seed=0), *batch))
        state, parts = meshed.jitted_train_step()(state, *batch, 0.01, 0.1, 0.9)
        assert state["step"] == 1 and np.isfinite(float(parts["loss"]))
    finally:
        D.shutdown()


def test_a_step_on_a_cuda_trainer_needs_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        CapturedStep(lambda x: x, torch.zeros(2))


def test_no_garbage_collection_runs_inside_a_capture():
    """A capture runs with the cyclic collector off, and leaves it as it was,
    also when the captured function raises: a finalizer run inside it (a
    dropped graph's reset) would invalidate the capture."""
    import gc
    from yolo_continuous_tpu_torch.utils import capture
    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="inside"):
        with capture._no_collection():
            assert not gc.isenabled()
            raise RuntimeError("inside")
    assert gc.isenabled()
    gc.disable()
    try:
        with capture._no_collection():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
