"""The port's parallelism and memory options in one process: the sharding
rule against JAX's, ``bn_remat`` and the ``remat`` policies, a world-of-one
mesh, the refused ``xla_opts``.

- ``param_sharding_rule`` picks the leaves of yolov7-tiny that JAX's rule
  picks (``jax.eval_shape``, so nothing compiles; JAX paths named through
  ``tools/jax_weights.py``), the parameters and the optimizer's momentum;
- ``bn_remat`` and every ``remat`` policy give the plain step's loss,
  gradients and running statistics bit for bit on the CPU (the same ops in
  the same order), and the statistics move once a step;
- a mesh of one process (gloo) gives the plain step bit for bit.
The multi-process meshes are ``test_torch_port_distributed.py``'s.
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_port as TP
from yolo_continuous_tpu_torch.config.plan import TrainPlan, cvt_cfg
from yolo_continuous_tpu_torch.nn.builder import YoloModel, build_model_spec
from yolo_continuous_tpu_torch.parallel import mesh as M
from yolo_continuous_tpu_torch.tools.jax_weights import _torch_key
from yolo_continuous_tpu_torch.train.train_loop import Trainer

S = 64


def _tiny_cfg(**extra):
    return dict(TP.tiny_plan_cfg("Detect", S), model_cfg="cfg/net/yolov7-tiny.yaml", **extra)


def _fake_mesh(n_model: int, rank: int = 0):
    return types.SimpleNamespace(shape={"data": 1, "model": n_model}, model_rank=rank)


@pytest.mark.parametrize("n_model,min_channels", [(2, 64), (4, 128), (1, 16)])
def test_sharding_rule_picks_jax_leaves(n_model, min_channels):
    from yolo_continuous_tpu.nn.builder import YoloModel as JModel
    from yolo_continuous_tpu.nn.builder import build_model_spec as j_spec
    from yolo_continuous_tpu.parallel.mesh import make_mesh, param_sharding_rule
    from yolo_continuous_tpu.train.optimizer import make_optimizer
    from yolo_continuous_tpu.config.plan import TrainPlan as JPlan
    cfg = cvt_cfg("cfg/net/yolov7-tiny.yaml")
    jspec = j_spec(cfg, 3, TP.ANCHORS, 80)
    shapes = jax.eval_shape(lambda: JModel(spec=jspec).init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), False))
    rule = param_sharding_rule(make_mesh(8 // n_model, n_model), min_channels)
    spec = build_model_spec(cfg, 3, TP.ANCHORS, 80)

    def picked(tree):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {_torch_key([p.key for p in path[:-1]], path[-1].key, spec)
                for path, x in leaves if rule(x).spec != jax.sharding.PartitionSpec()}

    want = picked(shapes["params"])
    opt = jax.eval_shape(make_optimizer(JPlan(_tiny_cfg())).init, shapes["params"])
    assert picked(opt.momentum_buf) == want          # the momentum shards with its parameter
    port_rule = M.param_sharding_rule(_fake_mesh(n_model), min_channels)
    got = {n for n, p in YoloModel(spec).named_parameters() if port_rule(n, p) is not None}
    assert got == want
    assert (len(want) > 0) == (n_model > 1)


def test_shard_params_slices_optimizer_buffers_and_ema():
    """A state after a step: each sharded parameter, its momentum and its EMA
    entry keep the rank's slice of the output channels (axis 1 of an
    implicit)."""
    cfg = dict(TP.tiny_plan_cfg("IDetect", S), model_cfg=TP.SHARD_NET)
    tr = Trainer(TrainPlan(cfg), device="cpu")
    state = tr.init_state(seed=0)
    state, _ = tr.train_step(state, *TP.dist_batch(2), 0.01, 0.1, 0.9)
    full = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    params = dict(tr.model.named_parameters())
    moms = {n: state["opt"].state[p]["momentum_buffer"].clone() for n, p in params.items()}
    ema = {k: v.clone() for k, v in state["ema"].tree.items()}
    M.shard_params(_fake_mesh(2, rank=1), state, min_channels=TP.SHARD_MIN_CHANNELS)
    shards = tr.model.shards
    assert "model.6.ia.0.implicit" in shards and shards["model.6.ia.0.implicit"] == 1
    assert shards["model.2.conv.conv.weight"] == 0 and "model.6.m.0.weight" not in shards
    for n, axis in shards.items():
        want = full[n].chunk(2, axis)[1]
        assert torch.equal(params[n], want)
        assert torch.equal(state["opt"].state[params[n]]["momentum_buffer"],
                           moms[n].chunk(2, axis)[1])
        assert torch.equal(state["ema"].tree[n], ema[n].chunk(2, axis)[1])


def _step_parts(cfg, remat=None):
    """Loss, gradients and running statistics of one forward and backward in
    train mode, and the state after one ``train_step``."""
    tr = Trainer(TrainPlan(cfg), device="cpu", remat=remat)
    state = tr.init_state(seed=0)
    before = {k: v.clone() for k, v in tr.model.state_dict().items() if "running_" in k}
    x, labels, lmask = tr._inputs(*TP.dist_batch(2))
    tr.model.train()
    loss, parts = tr.loss_from_outputs(tr.model(x), labels, lmask)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
    running = {k: v.clone() for k, v in tr.model.state_dict().items() if "running_" in k}
    state = tr.init_state(seed=0)
    state, metrics = tr.train_step(state, *TP.dist_batch(2), 0.01, 0.1, 0.937)
    return dict(loss=loss, grads=grads, running=running, before=before, metrics=metrics,
                state=tr.model.state_dict())


@pytest.fixture(scope="module")
def plain_step():
    return _step_parts(_tiny_cfg())


@pytest.mark.parametrize("bn_remat,remat", [(True, None), (False, "full"), (False, True),
                                            (False, "conv"), (False, "dots"), (True, "conv")])
def test_remat_is_bit_equal(plain_step, bn_remat, remat):
    got = _step_parts(_tiny_cfg(bn_remat=bn_remat), remat)
    want = plain_step
    assert torch.equal(got["loss"], want["loss"])
    for n, g in want["grads"].items():
        assert torch.equal(got["grads"][n], g), n
    for k, v in want["running"].items():       # updated once: as the plain forward, which moves
        assert torch.equal(got["running"][k], v), k
    assert any(not torch.equal(v, want["before"][k]) for k, v in want["running"].items())
    for k, v in want["metrics"].items():
        assert torch.equal(got["metrics"][k], v), k
    for k, v in want["state"].items():
        assert torch.equal(got["state"][k], v), k


def test_remat_from_the_plan_and_unknown_policies():
    assert Trainer(TrainPlan(_tiny_cfg(remat="conv")), device="cpu").remat == "conv"
    assert Trainer(TrainPlan(_tiny_cfg(bn_remat=True)), device="cpu").model.bn_remat
    with pytest.raises(ValueError, match="unknown remat policy"):
        Trainer(TrainPlan(_tiny_cfg()), device="cpu", remat="attention")


def test_xla_opts_is_refused():
    with pytest.raises(NotImplementedError, match="xla_opts"):
        Trainer(TrainPlan(_tiny_cfg(xla_opts={"xla_tpu_scoped_vmem_limit_kib": 65536})),
                device="cpu")


def test_world_of_one_mesh_is_bit_equal(tmp_path):
    """A mesh of one gloo process: every collective is the identity, and the
    step (with bn_remat) equals the unmeshed step bit for bit."""
    from yolo_continuous_tpu_torch.parallel import distributed as D
    cfg = _tiny_cfg(bn_remat=True)
    batch = TP.dist_batch(2)
    tr = Trainer(TrainPlan(cfg), device="cpu")
    state, want = tr.train_step(tr.init_state(seed=0), *batch, 0.01, 0.1, 0.9)
    D.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu", timeout_s=30)
    try:
        mesh = M.make_mesh(1, 1)
        assert mesh.shape == {"data": 1, "model": 1} and D.local_batch_size(2, mesh) == 2
        from torch.distributed.tensor import Replicate, Shard
        assert M.data_sharding(mesh, 4) == (Shard(0), Replicate())
        assert M.replicated(mesh) == (Replicate(), Replicate())
        tr1 = Trainer(TrainPlan(cfg), device="cpu", mesh=mesh)
        state1 = M.shard_params(mesh, tr1.init_state(seed=0))
        state1, got = tr1.train_step(state1, *M.shard_batch(mesh, batch), 0.01, 0.1, 0.9)
        full = M.gather_params(mesh, state1)
        with pytest.raises(ValueError, match="mesh"):
            tr1.run(log=lambda *_: None)
    finally:
        D.shutdown()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k, v in state["model"].state_dict().items():
        assert torch.equal(full["model"][k], v), k
    assert full["ema"]["updates"] == 1


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    from yolo_continuous_tpu_torch.parallel import distributed as D
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    D.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert D.process_count() == 1 and D.process_index() == 0
    with pytest.raises(RuntimeError, match="process group"):
        M.make_mesh(1, 1)
    with pytest.raises(AssertionError):
        D.local_batch_size(3, types.SimpleNamespace(shape={"data": 2}))
    got = D.host_local_batch(types.SimpleNamespace(device=torch.device("cpu")),
                             {"x": np.ones((2, 3), np.float32), "y": [np.zeros(2)]})
    assert torch.is_tensor(got["x"]) and got["x"].shape == (2, 3) and torch.is_tensor(got["y"][0])
