"""PyTorch port vs JAX package: one whole train step, and resume.

``Trainer.train_step`` (port) against ``Trainer.train_step_fn`` (JAX, CPU,
fp32, jitted) from the same lively weights, images and labels (numpy,
seeded), lr_w, lr_b, mom = 0.01, 0.1, 0.937:

- a tiny 3-level IAuxDetect net (lead and aux maps; five body convs): loss
  parts rtol 1e-5 and ``num_fg`` exact; every parameter's update (new - old)
  and momentum buffers rtol 1e-3 with atol 1e-5 x the largest (a weight
  gradient is a sum of up to 2048 products with cancellation, summed in
  another order: its smallest entries differ by 1e-4 of themselves, 8e-6 of
  the largest update); BN running statistics and the EMA rtol 1e-5 with atol
  2e-5 x the tensor's largest value (a batch mean of 2048 values, summed in
  another order);
- yolov7-tiny at 64 px, batch 2, max_gt 8 (78 layers, 55 BatchNorms in train
  mode): ``num_fg`` exact, loss parts rtol 1e-3, updates and momentum
  buffers within 3e-2 relative L2 over all tensors, BN running statistics
  and the EMA within 1e-2 of each tensor's largest value. The reason is
  measured by ``test_the_gap_is_the_order_of_the_bn_sums``: XLA sums a
  batch statistic sequentially, torch pairwise (the port's within 2e-6 of
  fp64 at n = 2048 and no farther from it than JAX's;
  tests/test_torch_port_optim.py); each train-mode BatchNorm amplifies the
  difference down the depth. With the port's sums made sequential the gap
  shrinks more than 3x.

The JAX step is compiled once per module (a module-scoped fixture).
"""
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_port import lively, tiny_plan_cfg
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.train.ema import ema_init
from yolo_continuous_tpu.train.train_loop import Trainer as JaxTrainer
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.nn import layers
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax
from yolo_continuous_tpu_torch.train.checkpoint import save_checkpoint, try_load
from yolo_continuous_tpu_torch.train.train_loop import Trainer

HYPER = (0.01, 0.1, 0.937)
PARTS = ("loss", "box", "obj", "cls")


def _tiny_v7_cfg():
    cfg = yaml.safe_load(open("cfg/chip_tiny.yaml"))
    cfg.update(image_size=64, batch_size=2, max_boxes=8, labels=["a", "b", "c"],
               save_dir="/nonexistent/")
    return cfg


CONFIGS = {"iaux": lambda: tiny_plan_cfg("IAuxDetect", 64), "yolov7-tiny": _tiny_v7_cfg}


def _batch(nc, seed=2):
    rs = np.random.RandomState(seed)
    x = rs.rand(2, 64, 64, 3).astype(np.float32)
    labels = np.zeros((2, 8, 5), np.float32)
    lmask = np.zeros((2, 8), bool)
    for b in range(2):
        for g in range(3 + b):
            labels[b, g] = [rs.randint(nc), rs.uniform(.25, .75), rs.uniform(.25, .75),
                            rs.uniform(.15, .5), rs.uniform(.15, .5)]
            lmask[b, g] = True
    return x, labels, lmask


def _port_step(cfg, params, stats, batch, n=1):
    tr = Trainer(TrainPlan(dict(cfg)), device="cpu")
    state = tr.init_state(state_dict=state_dict_from_jax(tr.spec, params, stats))
    old = {k: v.clone() for k, v in state["model"].state_dict().items()}
    for _ in range(n):
        state, parts = tr.train_step(state, *batch, *HYPER)
    return tr, state, old, {k: float(v) for k, v in parts.items()}


def _jax_and_port_step(name):
    cfg = CONFIGS[name]()
    jt = JaxTrainer(JaxPlan(dict(cfg)), dtype=jnp.float32)
    st = jt.init_state(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    params, stats = lively(st["params"], rs), lively(st["batch_stats"], rs)
    st = dict(st, params=params, batch_stats=stats, opt=jt.optimizer.init(params),
              ema=ema_init({"params": params, "batch_stats": stats}))
    batch = _batch(len(cfg["labels"]))
    new, metrics = jax.jit(jt.train_step_fn)(st, *map(jnp.asarray, batch), *HYPER)
    tr, state, old, parts = _port_step(cfg, params, stats, batch)
    spec = tr.spec
    return dict(name=name, cfg=cfg, params=params, stats=stats, batch=batch,
                jax_parts={k: float(v) for k, v in metrics.items()}, parts=parts,
                want=state_dict_from_jax(spec, new["params"], new["batch_stats"]),
                momentum=state_dict_from_jax(spec, new["opt"].momentum_buf, {}),
                ema=state_dict_from_jax(spec, new["ema"].tree["params"],
                                        new["ema"].tree["batch_stats"]),
                state=state, old=old)


@pytest.fixture(scope="module")
def iaux():
    return _jax_and_port_step("iaux")


@pytest.fixture(scope="module")
def deep():
    return _jax_and_port_step("yolov7-tiny")


def _rel_l2(got, want, keys):
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in keys)
    return (num / sum(float((want[k].double() ** 2).sum()) for k in keys)) ** 0.5


def _params(step):
    return [n for n, _ in step["state"]["model"].named_parameters()]


def _updates(step):
    got = step["state"]["model"].state_dict()
    names = _params(step)
    return ({n: got[n] - step["old"][n] for n in names},
            {n: step["want"][n] - step["old"][n] for n in names}, names)


def _momentum(step):
    opt = step["state"]["opt"]
    named = dict(step["state"]["model"].named_parameters())
    return {n: opt.state[p]["momentum_buffer"] for n, p in named.items()}, list(named)


def _stats_keys(step):
    return [k for k in step["want"] if k.endswith(("running_mean", "running_var"))]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_parts_and_num_fg_match_jax(name, request):
    step = request.getfixturevalue("deep" if name == "yolov7-tiny" else name)
    p, j = step["parts"], step["jax_parts"]
    assert p["num_fg"] == j["num_fg"] > 0
    rtol = 1e-5 if name == "iaux" else 1e-3
    for k in PARTS:
        assert j[k] > 0
        np.testing.assert_allclose(p[k], j[k], rtol=rtol, err_msg=k)


def _elementwise(got, want, keys, rtol, atol_of):
    for k in keys:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol, atol=atol_of(w), err_msg=k)


def test_shallow_step_updates_momentum_and_ema_match_jax(iaux):
    """Updates and momentum buffers: rtol 1e-3, atol 1e-5 x the largest (of
    all tensors); BN running statistics and the EMA: rtol 1e-5, atol 2e-5 x
    the tensor's largest value (a batch mean of 2048 values summed in another
    order)."""
    upd, wupd, names = _updates(iaux)
    biggest = max(float(v.abs().max()) for v in wupd.values())
    _elementwise(upd, wupd, names, 1e-3, lambda w: 1e-5 * biggest)
    bufs, names = _momentum(iaux)
    biggest = max(float(iaux["momentum"][n].abs().max()) for n in names)
    _elementwise(bufs, iaux["momentum"], names, 1e-3, lambda w: 1e-5 * biggest)
    stats = iaux["state"]["model"].state_dict()
    _elementwise(stats, iaux["want"], _stats_keys(iaux), 1e-5, lambda w: 2e-5 * np.abs(w).max())
    ema = iaux["state"]["ema"]
    assert ema.updates == 1
    _elementwise(ema.tree, iaux["ema"], list(ema.tree), 1e-5, lambda w: 2e-5 * np.abs(w).max())


def test_deep_step_updates_momentum_and_ema_match_jax(deep):
    """Updates and momentum buffers within 3e-2 relative L2 over all tensors;
    BN running statistics and the EMA within 1e-2 of each tensor's largest
    value."""
    upd, wupd, names = _updates(deep)
    assert _rel_l2(upd, wupd, names) <= 3e-2
    bufs, names = _momentum(deep)
    assert _rel_l2(bufs, deep["momentum"], names) <= 3e-2
    got = deep["state"]["model"].state_dict()
    ema = deep["state"]["ema"]
    for tree, want, keys in ((got, deep["want"], _stats_keys(deep)),
                             (ema.tree, deep["ema"], list(ema.tree))):
        for k in keys:
            w = want[k].numpy()
            assert np.abs(tree[k].numpy() - w).max() <= 1e-2 * np.abs(w).max(), k


def test_the_gap_is_the_order_of_the_bn_sums(deep, monkeypatch):
    """The deep net's gap to JAX comes from the order of the BatchNorm sums:
    with the port's batch statistics summed sequentially, as XLA does on
    the CPU, the box loss and the updates come several times closer to JAX's."""

    def sequential(x):
        rows = x.float().permute(0, 2, 3, 1).reshape(-1, x.shape[1])
        s = s2 = torch.zeros(x.shape[1])
        for r in rows:
            s, s2 = s + r, s2 + r * r
        mean = s / rows.shape[0]
        return mean, torch.clamp(s2 / rows.shape[0] - mean * mean, min=0.0)

    monkeypatch.setattr(layers, "batch_stats", sequential)
    _, state, old, parts = _port_step(deep["cfg"], deep["params"], deep["stats"], deep["batch"])
    upd, wupd, names = _updates(deep)
    seq = {n: state["model"].state_dict()[n] - old[n] for n in names}
    assert _rel_l2(seq, wupd, names) * 3 < _rel_l2(upd, wupd, names)
    j = deep["jax_parts"]["box"]
    assert abs(parts["box"] - j) * 3 < abs(deep["parts"]["box"] - j)


def test_resume_is_bit_identical_to_an_uninterrupted_run(tmp_path):
    """Save after 2 steps, load into a fresh Trainer, run 2 more: the model,
    the optimizer state, the EMA and the counters equal 4 uninterrupted steps
    bit for bit (port only)."""
    cfg = tiny_plan_cfg("IAuxDetect", 64)
    batches = [_batch(2, seed) for seed in range(4)]

    def run(state, tr, bs):
        for b in bs:
            state, _ = tr.train_step(state, *b, *HYPER)
        return state

    tr = Trainer(TrainPlan(dict(cfg)), device="cpu")
    straight = run(tr.init_state(seed=3), tr, batches)
    tr2 = Trainer(TrainPlan(dict(cfg)), device="cpu")
    half = run(tr2.init_state(seed=3), tr2, batches[:2])
    path = str(tmp_path / "t.train.pt")
    save_checkpoint(path, half)
    tr3 = Trainer(TrainPlan(dict(cfg)), device="cpu")
    resumed = run(try_load(path, tr3.init_state(seed=9)), tr3, batches[2:])
    assert resumed["step"] == straight["step"] == 4
    assert resumed["ema"].updates == straight["ema"].updates == 4
    for k, v in straight["model"].state_dict().items():
        assert torch.equal(resumed["model"].state_dict()[k], v), k
    for k, v in straight["ema"].tree.items():
        assert torch.equal(resumed["ema"].tree[k], v), k
    a, b = straight["opt"].state_dict(), resumed["opt"].state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        assert all(torch.equal(st[k], b["state"][i][k]) for k in st)
    assert try_load(str(tmp_path / "none.train.pt"), straight) is None
    assert not os.path.exists(path + ".tmp")


def test_eval_loss_matches_jax(iaux):
    """The loss with running statistics (eval mode), on the weights before
    the step: JAX's ``jitted_eval_loss``."""
    step = iaux
    jt = JaxTrainer(JaxPlan(dict(step["cfg"])), dtype=jnp.float32)
    want = float(jt.jitted_eval_loss()(step["params"], step["stats"],
                                       *map(jnp.asarray, step["batch"])))
    tr = Trainer(TrainPlan(dict(step["cfg"])), device="cpu")
    state = tr.init_state(state_dict=state_dict_from_jax(tr.spec, step["params"], step["stats"]))
    got = float(tr.eval_loss(state, *step["batch"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_trainer_raises_without_cuda_and_for_an_ibin_head(monkeypatch):
    """Raises without a card; an IBin head now trains with bin_yolo_loss
    (its parity: tests/test_torch_port_bin_loss.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainPlan(tiny_plan_cfg("IDetect", 64)))
    tr = Trainer(TrainPlan(tiny_plan_cfg("IBin", 64)), device="cpu")
    _, parts = tr.train_step(tr.init_state(seed=0), *_batch(2), *HYPER)
    assert set(parts) == {"loss", "box", "obj", "cls", "bin", "num_fg"}


def test_train_mode_keeps_fp32_master_weights_and_logits():
    """A bf16 body on the CPU: the weights stay fp32 (each conv casts its own
    per call), the head maps come out fp32, and the step updates the fp32
    weights."""
    tr = Trainer(TrainPlan(tiny_plan_cfg("IDetect", 64)), device="cpu", dtype=torch.bfloat16)
    state = tr.init_state(seed=0)
    model = state["model"].train()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.rand(2, 3, 64, 64)
    assert all(m.dtype == torch.float32 for m in model(x))
    w0 = model.model[0].conv.weight.detach().clone()
    _, parts = tr.train_step(state, *_batch(2), *HYPER)
    assert np.isfinite(float(parts["loss"])) and model.model[0].conv.weight.dtype == torch.float32
    assert not torch.equal(model.model[0].conv.weight, w0)
