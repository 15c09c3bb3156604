"""PyTorch port vs JAX package: ``Trainer.run`` from a plan, and its CLI.

- ``Trainer.run`` against JAX's, 2 epochs x 2 steps of the tiny IAuxDetect
  net (64 px, fp32) on square images, both warm-started from one JAX
  checkpoint of lively weights and both given one identity ``AugConfig``
  (no jitter, no HSV gain, scale 1, no flips, no mosaic), so both runs are
  deterministic (64 px images need no resize, so JAX's C++ stager, where it
  builds, and the port's cv2 stage the same canvases): every step's loss
  within rtol 1e-5 of JAX's (the tolerance
  ``test_torch_port_train.py`` holds this net's step to), the epoch means too,
  and the same checkpoint files written (the port's names: ``.train.pt`` for
  JAX's ``.msgpack``).
- The port alone, with the real augmentation (mosaic, mixup, UD flip):
  killed after epoch 2 and resumed equals an uninterrupted 4-epoch run bit
  for bit; ``device_cache`` on and off give equal losses; ``val_map_every``
  writes ``.bestmap``; ``host_sync_every`` is refused; the budget gate,
  ``stop_after_epoch`` and warm start as JAX has them; the ``train`` CLI
  runs with ``--device cpu``.
"""
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_port import lively, tiny_plan_cfg, write_dataset
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.ops.augment import AugConfig as JaxAugConfig
from yolo_continuous_tpu.train.checkpoint import save_checkpoint as jax_save
from yolo_continuous_tpu.train.ema import ema_init
from yolo_continuous_tpu.train.train_loop import Trainer as JaxTrainer
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.ops.augment import AugConfig
from yolo_continuous_tpu_torch.train import __main__ as train_cli
from yolo_continuous_tpu_torch.train.checkpoint import load_checkpoint, train_checkpoint_path
from yolo_continuous_tpu_torch.train.train_loop import Trainer

pytest.importorskip("cv2")
IDENTITY = dict(size=64, jitter=0.0, hue=0.0, sat=0.0, val=0.0, scale_min=1.0, scale_max=1.0,
                flip_lr=0.0)


def _cfg(ann, save_dir, **kw):
    cfg = tiny_plan_cfg("IAuxDetect", 64)
    cfg.update(dict(dict(train=ann, val=ann, epochs=2, batch_size=2, save_dir=str(save_dir),
                         save_name="t", resume=False, seed=3), **kw))
    return cfg


@pytest.fixture(scope="module")
def square(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("sq"), 4, seed=4, square=True)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("mixed"), 6, seed=5)


def test_run_matches_jax(square, tmp_path):
    cfg = _cfg(square, tmp_path / "jax", mosaic_prob=0.0)
    jt = JaxTrainer(JaxPlan(dict(cfg)), dtype=jnp.float32)
    st = jt.init_state(jax.random.PRNGKey(0))
    rs = np.random.RandomState(1)
    params, stats = lively(st["params"], rs), lively(st["batch_stats"], rs)
    warm = str(tmp_path / "warm.msgpack")
    jax_save(warm, dict(st, params=params, batch_stats=stats,
                        ema=ema_init({"params": params, "batch_stats": stats})))
    cfg["init_weights_from"] = warm

    jt = JaxTrainer(JaxPlan(dict(cfg)), dtype=jnp.float32)
    jt.aug_cfg = JaxAugConfig(**IDENTITY)
    jax_losses, step = [], jax.jit(jt.train_step_fn, donate_argnums=(0,))

    def jax_step(*args):
        out = step(*args)
        jax_losses.append(float(out[1]["loss"]))
        return out

    jt._jit_cache["train_step"] = jax_step
    jax_logs = []
    jt.run(log=jax_logs.append)

    cfg["save_dir"] = str(tmp_path / "port")
    tr = Trainer(TrainPlan(dict(cfg)), device="cpu")
    tr.aug_cfg = AugConfig(**IDENTITY)
    port_losses, train_step = [], tr.train_step

    def port_step(*args):
        state, metrics = train_step(*args)
        port_losses.append(float(metrics["loss"]))
        return state, metrics

    tr.train_step = port_step
    logs = []
    state = tr.run(log=logs.append)
    assert state["step"] == 4 and len(port_losses) == len(jax_losses) == 4
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    np.testing.assert_allclose([s["loss"] for s in tr.epoch_stats],
                               [np.mean(jax_losses[:2]), np.mean(jax_losses[2:])], rtol=1e-5)
    assert [l.split()[:2] for l in logs if "loss" in l] == \
        [l.split()[:2] for l in jax_logs if "loss" in l]
    assert sorted(os.listdir(tmp_path / "jax")) == ["t.msgpack", "t.msgpack.last"]
    assert sorted(os.listdir(tmp_path / "port")) == ["t.train.pt", "t.train.pt.last"]


def _run(cfg, log=None, **cfg_kw):
    cfg = dict(cfg, **cfg_kw)
    tr = Trainer(TrainPlan(cfg), device="cpu")
    logs = []
    state = tr.run(log=log or logs.append)
    return tr, state, logs


def _flat(state):
    out = {f"model.{k}": v for k, v in state["model"].state_dict().items()}
    out.update({f"ema.{k}": v for k, v in state["ema"].tree.items()})
    for i, st in state["opt"].state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items() if torch.is_tensor(v)})
    return out


def _real_aug_cfg(ann, save_dir, **kw):
    return _cfg(ann, save_dir, enhance=True, mosaic_prob=0.7, mixup_prob=0.5, **kw)


def test_resume_matches_uninterrupted(mixed, tmp_path):
    full = _real_aug_cfg(mixed, tmp_path / "a", epochs=4)
    tr_a, state_a, logs_a = _run(full)
    assert tr_a.aug_cfg.flip_ud == 0.5 and state_a["step"] == 12

    class Killed(Exception):
        pass

    logs_b = []

    def killer(line):
        logs_b.append(line)
        if line.startswith("epoch 2/4 loss"):
            raise Killed

    cfg_b = dict(full, save_dir=str(tmp_path / "b"))
    with pytest.raises(Killed):
        _run(cfg_b, log=killer)
    _, state_b, logs_b2 = _run(cfg_b, resume=True)
    assert "resumed at step 3" in logs_b2
    strip = lambda ls: [" ".join(l.split()[:6]) for l in ls
                        if l.startswith("epoch") and "loss" in l]
    assert strip(logs_b2) == strip(logs_a)[1:]
    a, b = _flat(state_a), _flat(state_b)
    assert state_b["step"] == 12 and set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_device_cache_on_and_off_give_equal_losses(mixed, tmp_path):
    cfg = _real_aug_cfg(mixed, tmp_path, epochs=2)
    runs = [_run(cfg, device_cache=on, save_name=f"c{on}") for on in (True, False)]
    (on, _, logs_on), (off, _, _) = runs
    assert on.epoch_stats[0]["device_cache"] and not off.epoch_stats[0]["device_cache"]
    assert [s["loss"] for s in on.epoch_stats] == [s["loss"] for s in off.epoch_stats]
    assert any("device cache: 6 staged images" in l for l in logs_on)
    for st in on.epoch_stats + off.epoch_stats:     # the host's wait for each step's batch
        waits = st["data_wait_ms_steps"]
        assert len(waits) == st["steps"] == 3 and min(waits) >= 0.0
        assert st["data_wait_ms"] == pytest.approx(sum(waits) / 3)


def test_host_sync_every_is_refused(mixed, tmp_path):
    with pytest.raises(NotImplementedError, match="host_sync_every"):
        Trainer(TrainPlan(_cfg(mixed, tmp_path, host_sync_every=2)), device="cpu")


def test_val_map_every_writes_bestmap(mixed, tmp_path):
    cfg = _real_aug_cfg(mixed, tmp_path, epochs=1, val_map_every=1)
    tr, _, logs = _run(cfg)
    best = train_checkpoint_path(os.path.join(str(tmp_path), "t.msgpack"))
    assert any("val mAP@0.5:0.95" in l and "(best)" in l for l in logs), logs
    assert os.path.exists(best + ".bestmap") and os.path.exists(best + ".last")
    assert set(tr.epoch_stats[0]["map"]) == {"mAP@0.5", "mAP@0.5:0.95"}


def test_device_cache_budget_gate(mixed, tmp_path):
    def logs_with(**kw):
        return "\n".join(_run(_cfg(mixed, tmp_path, epochs=0), **kw)[2])

    assert "device cache auto-enabled" in logs_with()
    small = logs_with(device_cache_budget_mb=0.0001)
    assert "auto-enabled" not in small and "WARNING" not in small
    assert "WARNING: device_cache pool" in logs_with(device_cache=True,
                                                     device_cache_budget_mb=0.0001)


def test_stop_after_epoch_and_warm_start(mixed, tmp_path):
    cfg = _cfg(mixed, tmp_path, epochs=4, stop_after_epoch=1, save_name="donor")
    tr, state, logs = _run(cfg)
    assert state["step"] == 3 and any("epoch 1/4" in l for l in logs)
    assert not any("epoch 2/4" in l for l in logs)
    donor = train_checkpoint_path(os.path.join(str(tmp_path), "donor.msgpack"))
    _, ft, logs = _run(cfg, epochs=0, save_name="ft", init_weights_from=donor)
    assert any("warm start" in l for l in logs) and ft["step"] == 0
    ema = load_checkpoint(donor)["ema"]["tree"]
    for k, v in ft["model"].state_dict().items():
        if k in ema:
            assert torch.equal(v, ema[k]), k


def test_train_cli_runs_on_the_cpu(mixed, tmp_path):
    path = tmp_path / "plan.yaml"
    path.write_text(yaml.safe_dump(_cfg(mixed, tmp_path, epochs=1)))
    state = train_cli.main([str(path), "--device", "cpu"])
    assert state["step"] == 3 and os.path.exists(tmp_path / "t.train.pt.last")
    with pytest.raises(NotImplementedError, match="item 7"):
        train_cli.main([str(path), "--device", "cpu", "--verbose"])
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main([str(path)])
