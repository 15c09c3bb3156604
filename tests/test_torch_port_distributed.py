"""The port's train step over a (data, model) mesh of processes, on gloo.

Each case starts its ranks (``_torch_dist_worker.py``) as child processes
that meet through a file store in ``tmp_path`` (no ports, so parallel test
workers cannot collide), and holds their one step to the port's 1-process
step on the same global batch, from the same seeded state:

- the shallow IDetect net (``_torch_port.SHARD_NET``, min_channels 16, so
  the "model" axis shards a plain, a depthwise and a RepConv kernel and the
  head's ImplicitA): loss and parts within rtol 1e-5, the updated weights,
  running statistics and EMA (gathered whole by ``gather_params``) within
  1e-5 relative L2 over all tensors: collectives and channel slices only
  reorder fp32 sums;
- raccoon_tiny @64 (yolov7-tiny, Adam) on 2 x 1: the loss within the bound
  of the JAX package's ``tests/test_distributed.py`` (1e-3 relative).

Each rank also takes the eval loss of its slice before the step, which must
be the 1-process eval loss of the global batch on every rank (rtol 1e-5): a
mesh's ``eval_loss`` is the global batch's, as JAX's ``jitted_eval_loss`` of
a batch sharded over "data". ``dist_batch(halves=True)`` gives the halves of
the batch different label counts, so that a rank's own normalizers would give
another loss; the step runs on it too, holding ``_global_parts`` where the
ranks' shares differ. On gloo the Trainer's compiled functions are the eager
ones, which the ranks call.

The 2 x 2 mesh (4 processes) turns ``bn_remat`` on, as
``__graft_entry__.py:97-102`` does for its tensor-sharded variant. Every
child has its own timeout and is killed on expiry; a lost rank fails its
collective within the group's 60 s timeout, so no case can hang the suite.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_port as TP
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.train.train_loop import Trainer

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD_TIMEOUT_S = 120
GLOBAL_BS = 4


def _single_process(case: str, bn_remat: bool, device="cpu", halves: bool = False):
    """The 1-process eval loss, then step, on the whole global batch (fp32)."""
    torch.manual_seed(0)
    trainer = Trainer(TrainPlan(dict(TP.dist_plan_cfg(case, GLOBAL_BS), bn_remat=bn_remat)),
                      device=device, dtype=torch.float32)
    state = trainer.init_state(seed=0)
    batch = TP.dist_batch(GLOBAL_BS, halves=halves)
    eval_loss = float(trainer.eval_loss(state, *batch))
    state, metrics = trainer.train_step(state, *batch, 0.01, 0.1, 0.9)
    return metrics, state, eval_loss


def _run_ranks(tmp_path, n_data: int, n_model: int, case: str, bn_remat: bool,
               device: str = "cpu", halves: bool = False) -> dict:
    world = n_data * n_model
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_worker.py"), str(r), str(world),
         str(n_data), str(n_model), str(tmp_path / "store"), str(tmp_path), case,
         "1" if bn_remat else "0", device, "halves" if halves else "even"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + f"\n[killed after {CHILD_TIMEOUT_S} s]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {n_data}x{n_model} failed:\n{out[-4000:]}"
    return torch.load(tmp_path / "result.pt", weights_only=False)


def _rel_l2(got: dict, want: dict) -> float:
    keys = [k for k in want if want[k].is_floating_point()]
    num = sum(float(((got[k].double() - want[k].cpu().double()) ** 2).sum()) for k in keys)
    den = sum(float((want[k].cpu().double() ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def _check_eval_losses(got: dict, want: float, world: int, rtol: float = 1e-5) -> None:
    """Every rank's eval loss is the 1-process eval loss of the global batch."""
    assert got["eager"] and len(got["eval_losses"]) == world
    for r, loss in enumerate(got["eval_losses"]):
        np.testing.assert_allclose(loss, want, rtol=rtol, err_msg=f"rank {r}")


def _check_mesh_step(tmp_path, n_data: int, n_model: int, bn_remat: bool,
                     halves: bool = False) -> None:
    """The shallow net's ranks against the 1-process eval loss and step."""
    got = _run_ranks(tmp_path, n_data, n_model, "shallow", bn_remat, halves=halves)
    metrics, state, eval_loss = _single_process("shallow", bn_remat, halves=halves)
    _check_eval_losses(got, eval_loss, n_data * n_model)
    if n_model > 1:          # the model axis really sharded kernels and implicits
        assert any(k.endswith("implicit") for k in got["shards"])
        assert any(k.endswith("conv.weight") for k in got["shards"])
        assert "model.2.conv.conv.weight" in got["shards"]          # the depthwise conv
    else:
        assert got["shards"] == {}
    for k in ("loss", "box", "obj", "cls"):
        np.testing.assert_allclose(float(got["metrics"][k]), float(metrics[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(got["metrics"]["num_fg"]) == int(metrics["num_fg"]) > 0
    want = state["model"].state_dict()
    assert set(got["state"]["model"]) == set(want)
    for k, v in want.items():
        assert got["state"]["model"][k].shape == v.shape, k
    assert _rel_l2(got["state"]["model"], want) < 1e-5
    running = [k for k in want if "running_" in k]
    assert _rel_l2({k: got["state"]["model"][k] for k in running},
                   {k: want[k] for k in running}) < 1e-5
    assert _rel_l2(got["state"]["ema"]["tree"], state["ema"].tree) < 1e-5
    assert got["state"]["ema"]["updates"] == 1 and got["state"]["step"] == 1


@pytest.mark.parametrize("n_data,n_model,bn_remat", [(2, 1, False), (1, 2, False),
                                                     (2, 2, True)])
def test_mesh_step_equals_the_one_process_step(tmp_path, n_data, n_model, bn_remat):
    _check_mesh_step(tmp_path, n_data, n_model, bn_remat)


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2)])
def test_mesh_eval_loss_is_the_global_batch_loss(tmp_path, n_data, n_model):
    """Halves with 4 and 1 boxes an image: on 2 x 1 each rank's own
    normalizers would give its slice's loss, not the global batch's; the
    step's loss parts and state hold to the 1-process step there too."""
    _check_mesh_step(tmp_path, n_data, n_model, False, halves=True)


def test_raccoon_tiny_two_process_step(tmp_path):
    """The counterpart of the JAX package's 2-process step
    (``tests/_dist_worker.py``): yolov7-tiny @64, global batch 4, 2 x 1."""
    got = _run_ranks(tmp_path, 2, 1, "raccoon", False)
    metrics, _, eval_loss = _single_process("raccoon", False)
    loss, want = float(got["metrics"]["loss"]), float(metrics["loss"])
    assert np.isfinite(loss)
    assert abs(loss - want) < 1e-3 * max(1.0, abs(want)), (loss, want)
    _check_eval_losses(got, eval_loss, 2, rtol=1e-3)
