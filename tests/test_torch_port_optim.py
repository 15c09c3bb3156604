"""PyTorch port vs JAX package: the optimizer, the schedules, the EMA and the
train-mode layers (BatchNorm statistics, MP and SP gradients).

Tolerances: optimizer steps and the EMA rtol 1e-6 (the same fp32 formulas);
schedules exactly (the same host arithmetic); MP/SP tie gradients exactly.
BatchNorm's batch statistics are sums of n values in another order: XLA on
the CPU adds them one after another, torch pairwise. Their difference is held
to what the sequential sum's own error allows, and the port's statistics to
be at least as close to the fp64 values as JAX's are.
"""
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_port import ANCHORS, lively, tiny_head_net
from yolo_continuous_tpu.nn import layers as jax_layers
from yolo_continuous_tpu.nn.builder import YoloModel as JaxModel
from yolo_continuous_tpu.nn.builder import build_model_spec as jax_spec
from yolo_continuous_tpu.ops import schedules as jax_schedules
from yolo_continuous_tpu.train.ema import ema_init, ema_update
from yolo_continuous_tpu.train.optimizer import Optimizer, label_params as jax_labels
from yolo_continuous_tpu_torch.nn import layers
from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
from yolo_continuous_tpu_torch.ops import schedules
from yolo_continuous_tpu_torch.tools.jax_weights import _leaves, _torch_key, state_dict_from_jax
from yolo_continuous_tpu_torch.train.ema import ModelEMA, ema_decay
from yolo_continuous_tpu_torch.train.optimizer import label_params, make_optimizer


def _net(name):
    return yaml.safe_load(open(f"cfg/net/{name}.yaml")) if name.startswith("yolov7") \
        else tiny_head_net(name)


def _trees(name, nc=2, seed=1):
    cfg = _net(name)
    spec = jax_spec(cfg, 3, ANCHORS, nc)
    v = jax.eval_shape(lambda x: JaxModel(spec=spec).init(jax.random.PRNGKey(0), x, False),
                       jnp.zeros((1, 64, 64, 3)))
    rs = np.random.RandomState(seed)
    return cfg, spec, lively(v["params"], rs), lively(v["batch_stats"], rs)


# ---------------------------------------------------------------- groups

@pytest.mark.parametrize("name", ["yolov7", "yolov7-tiny", "IAuxDetect"])
def test_label_params_match_jax(name):
    """Every tensor lands in the group JAX's label gives its leaf (names
    mapped by state_dict_from_jax): BN weights of Conv, RepConv branches and
    its identity in bn_scale; implicit and every bias in bias."""
    cfg, spec, params, _ = _trees(name)
    port_spec = build_model_spec(cfg, 3, ANCHORS, 2)
    model = YoloModel(port_spec)
    ours = label_params(model)
    want = {}
    flat_labels = dict(_leaves(jax.tree.map(np.asarray, jax_labels(params),
                                            is_leaf=lambda x: isinstance(x, str))))
    for path, label in flat_labels.items():
        want[_torch_key(path[:-1], path[-1], port_spec)] = str(label)
    assert ours == want
    assert set(ours.values()) == {"bn_scale", "weight", "bias"}


# ---------------------------------------------------------------- optimizer

def _opt_case(adam, steps=2):
    cfg, spec, params, stats = _trees("IAuxDetect")
    port_spec = build_model_spec(cfg, 3, ANCHORS, 2)
    model = YoloModel(port_spec)
    model.load_state_dict(state_dict_from_jax(port_spec, params, stats))

    class Plan:
        weight_decay, momentum = 5e-4, 0.937
    Plan.adam = adam
    rs = np.random.RandomState(5)
    grads = [jax.tree.map(lambda p: rs.randn(*np.shape(p)).astype(np.float32), params)
             for _ in range(steps)]
    return port_spec, params, model, Plan, grads


def _hyper(lr_w, lr_b, mom):
    """The optimizer's device scalars (here on the CPU): lr_w, lr_b, mom."""
    return torch.tensor([lr_w, lr_b, mom], dtype=torch.float32)


@pytest.mark.parametrize("adam,steps", [pytest.param(False, 2, id="False"),
                                        pytest.param(True, 1, id="True"),
                                        pytest.param(False, 3, id="False-3-steps"),
                                        pytest.param(True, 3, id="True-3-steps")])
def test_optimizer_steps_match_jax(adam, steps):
    """SGD-Nesterov and Adam, their learning rates and momentum read from a
    device tensor (``Optimizer.step(hyper)``), over ``steps`` steps whose
    learning rates (other ones for the bias group) and momenta all change,
    as in the warm-up: new parameters and the optimizer state. (JAX computes
    Adam's bias correction 1 - 0.999^t in fp32, where the subtraction costs
    1.3e-5 of relative precision at t = 1: Adam's updates are held to rtol
    2e-5, its moments to 1e-6.)"""
    port_spec, params, model, plan, grads = _opt_case(adam, steps)
    hypers = [(0.01, 0.1, 0.8), (0.02, 0.05, 0.9), (0.03, 0.02, 0.937)][:steps]
    opt = Optimizer(adam=adam, weight_decay=plan.weight_decay)
    state, p = opt.init(params), params
    labels = jax_labels(params)
    for g, (lw, lb, m) in zip(grads, hypers):
        p, state = opt.update(g, state, p, labels,
                              jax_schedules.StepHyper(lr_weights=lw, lr_bias=lb, momentum=m))
    topt = make_optimizer(plan, model)
    named = dict(model.named_parameters())
    for g, hyper in zip(grads, hypers):
        sd = state_dict_from_jax(port_spec, g, {})
        for n, t in named.items():
            t.grad = sd[n].clone()
        topt.step(_hyper(*hyper))
    want = state_dict_from_jax(port_spec, p, {})
    bufs = [state.m, state.v] if adam else [state.momentum_buf]
    bufs = [state_dict_from_jax(port_spec, b, {}) for b in bufs]
    keys = ["exp_avg", "exp_avg_sq"] if adam else ["momentum_buffer"]
    old = state_dict_from_jax(port_spec, params, {})
    for n, t in named.items():
        if adam:
            np.testing.assert_allclose((t.detach() - old[n]).numpy(), (want[n] - old[n]).numpy(),
                                       rtol=2e-5, atol=1e-8, err_msg=n)
        else:
            np.testing.assert_allclose(t.detach().numpy(), want[n].numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=n)
        for key, buf in zip(keys, bufs):
            np.testing.assert_allclose(topt.state[t][key].numpy(), buf[n].numpy(), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{n} {key}")
    if adam:
        assert float(topt.state[named[n]]["step"]) == steps == int(state.step)


def test_optimizer_groups_take_their_hyper_parameters():
    """Each group its weight decay; ``bias`` steps with ``hyper[1]``, the
    other two with ``hyper[0]``, all with momentum ``hyper[2]``: a first step
    from zero buffers on unit gradients moves a parameter by lr (1 + m)
    (plus the decay's share on ``weight``)."""
    _, _, model, plan, _ = _opt_case(False)
    opt = make_optimizer(plan, model)
    labels = label_params(model)
    got = {g["label"]: (g["weight_decay"], len(g["params"])) for g in opt.param_groups}
    counts = {k: list(labels.values()).count(k) for k in got}
    assert got == {"bn_scale": (0.0, counts["bn_scale"]), "weight": (5e-4, counts["weight"]),
                   "bias": (0.0, counts["bias"])}
    named = dict(model.named_parameters())
    old = {n: t.detach().clone() for n, t in named.items()}
    for t in named.values():
        t.grad = torch.ones_like(t)
    lr_w, lr_b, m = 0.01, 0.1, 0.8
    opt.step(_hyper(lr_w, lr_b, m))
    for n, t in named.items():
        lr = lr_b if labels[n] == "bias" else lr_w
        g = 1.0 + (5e-4 * old[n] if labels[n] == "weight" else 0.0)
        torch.testing.assert_close(t.detach(), old[n] - lr * (1.0 + m) * g, rtol=1e-6,
                                   atol=1e-7, msg=n)


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("decay", [d.name for d in jax_schedules.DecayType])
@pytest.mark.parametrize("warmup", [True, False])
def test_lr_schedule_matches_jax(decay, warmup):
    """Every step of 3 epochs of 7 steps, and beyond the end (the clamp)."""
    kw = dict(lr_initial=0.01, lr_final=0.1, epochs=3, decay=decay, momentum=0.937,
              warmup=warmup, warmup_epochs=2, warmup_max_iter=10, steps_per_epoch=7)
    ours, ref = schedules.LRSchedule(**kw), jax_schedules.LRSchedule(**kw)
    for step in range(3 * 7 + 14):
        a, b = ours(step), ref(step)
        assert (a.lr_weights, a.lr_bias, a.momentum) == (b.lr_weights, b.lr_bias, b.momentum)
    assert ours.epoch_lr(99) == ours.epoch_lr(2)


# ---------------------------------------------------------------- EMA

def test_ema_ramp_matches_jax():
    """Five updates of a moving model: the ramped decay and every entry of the
    EMA (parameters and BN running statistics); a copy that aliases nothing."""
    cfg, spec, params, stats = _trees("IAuxDetect")
    port_spec = build_model_spec(cfg, 3, ANCHORS, 2)
    model = YoloModel(port_spec)
    model.load_state_dict(state_dict_from_jax(port_spec, params, stats))
    ema, jema = ModelEMA(model), ema_init({"params": params, "batch_stats": stats})
    assert all(ema.tree[k].data_ptr() != v.data_ptr() for k, v in model.state_dict().items()
               if k in ema.tree)
    rs = np.random.RandomState(3)
    for i in range(5):
        params = jax.tree.map(lambda p: p + 0.1 * rs.randn(*np.shape(p)).astype(np.float32),
                              params)
        model.load_state_dict(state_dict_from_jax(port_spec, params, stats))
        ema.update(model)
        jema = ema_update(jema, {"params": params, "batch_stats": stats})
    assert ema.updates == int(jema.updates) == 5
    d = float(0.9999 * (1.0 - jnp.exp(-jnp.asarray(5, jnp.float32) / 2000.0)))   # fp32, as JAX
    np.testing.assert_allclose(ema_decay(5)[0], d, rtol=1e-6)
    want = state_dict_from_jax(port_spec, jema.tree["params"], jema.tree["batch_stats"])
    assert set(ema.tree) == {k for k in want if not k.endswith("num_batches_tracked")}
    for k, v in ema.tree.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------- BatchNorm

def _bn_input(dtype):
    rs = np.random.RandomState(4)
    x = (rs.randn(2, 32, 32, 16) * 0.7 + rs.rand(16) * 2).astype(np.float32)   # NHWC
    return x if dtype == "float32" else np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_batch_statistics_match_jax(dtype):
    """``batch_stats`` against ``_batch_stats`` on a (2, 32, 32, 16) map (n =
    2048 a channel), in fp32 and bf16: both take fp32 statistics. The port's
    are within 1e-6 (mean) and 2e-6 (variance) of the largest fp64 value, and
    at least as close to fp64 as JAX's (a sequential sum, whose error E[x^2]
    - E[x]^2 then amplifies); so the two differ by no more than JAX's own
    error, plus the port's."""
    x = _bn_input(dtype)
    tdt = getattr(torch, dtype)
    jm, jv = (np.asarray(a) for a in jax_layers._batch_stats(jnp.asarray(x, getattr(jnp, dtype))))
    pm, pv = (a.numpy() for a in layers.batch_stats(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)))
    x64 = x.astype(np.float64).reshape(-1, 16)
    m64 = x64.mean(0)
    v64 = (x64 ** 2).mean(0) - m64 ** 2
    assert pm.dtype == pv.dtype == np.float32
    for got, ref, exact, tol in ((pm, jm, m64, 1e-6), (pv, jv, v64, 2e-6)):
        scale = np.abs(exact).max()
        assert np.abs(got - exact).max() <= tol * scale
        assert np.abs(got - exact).max() <= np.abs(ref - exact).max() + 1e-7 * scale


def test_bn_train_forward_gradients_and_running_stats_match_flax_batchnorm():
    """The port's BatchNorm2d in train mode against the JAX BatchNorm module
    (train=True, batch_stats mutable): output, the gradients of x, weight and
    bias, and the running statistics (momentum 0.9, unbiased variance)."""
    x = _bn_input("float32")
    rs = np.random.RandomState(6)
    scale, bias = (1 + 0.1 * rs.randn(16)).astype(np.float32), (0.1 * rs.randn(16)).astype(np.float32)
    mean0, var0 = (0.1 * rs.randn(16)).astype(np.float32), (rs.rand(16) + 0.5).astype(np.float32)
    r = rs.randn(*x.shape).astype(np.float32)
    bn = jax_layers.BatchNorm()
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean0, "var": var0}}}

    def f(xx, sc, bi):
        v = {"params": {"bn": {"scale": sc, "bias": bi}}, "batch_stats": variables["batch_stats"]}
        y, mut = bn.apply(v, xx, True, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut)

    (_, (jy, mut)), jg = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    m = layers.BatchNorm2d(16).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    y = m(xt)
    (y * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-5)
    for got, want in ((xt.grad.permute(0, 2, 3, 1), jg[0]), (m.weight.grad, jg[1]),
                      (m.bias.grad, jg[2])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(mut["batch_stats"]["bn"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(mut["batch_stats"]["bn"]["var"]),
                               rtol=4e-5)


# ---------------------------------------------------------------- pools

def _tied(shape, seed):
    """Small integers: 2 x 2 windows and 5-wide rows with ties everywhere."""
    return np.random.RandomState(seed).randint(0, 3, shape).astype(np.float32)


@pytest.mark.parametrize("pool,k", [("mp", 2), ("sp", 5), ("sp", 3)])
def test_pool_gradients_on_ties_match_jax(pool, k):
    """MP (reshape-max) splits a tied gradient evenly as JAX's ``max_pool``
    does (``F.max_pool2d`` would give it all to one element); SP (separable
    stride-1 pools) routes it as JAX's ``reduce_window`` does."""
    x = _tied((2, 8, 8, 4), k)
    r = np.random.RandomState(9).randn(*(np.asarray(getattr(jax_layers, pool)(jnp.asarray(x), k))
                                         .shape)).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(getattr(jax_layers, pool)(v, k) * r))(jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = getattr(layers, pool)(xt, k)
    (out * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(getattr(jax_layers, pool)(jnp.asarray(x), k)))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    if pool == "mp":      # ties were shared: more inputs got gradient than there are outputs
        assert np.count_nonzero(np.asarray(jg)) > r.size
