"""One rank of the port's multi-process train step (test_torch_port_distributed.py).

Each process joins a gloo group through a file store, lays the processes out
as an ``n_data`` x ``n_model`` mesh, builds the same seeded state, shards it
(``parallel/mesh.shard_params``), feeds its slice of the fixed global batch
(``shard_batch``) to one ``Trainer.train_step``, and rank 0 writes the loss
parts and the gathered state (``gather_params``) to ``<outdir>/result.pt``.

With the device ``cuda`` every rank runs on the one card and the ranks meet
through gloo, which takes CUDA tensors (NCCL puts no two ranks on one
device): the card-side check of the sharded convolutions.

Usage: python _torch_dist_worker.py <rank> <world> <n_data> <n_model> <store> <outdir>
       <case: shallow | raccoon> <bn_remat: 0 | 1> [<device: cpu | cuda>]
"""
import os
import sys

rank, world, n_data, n_model = (int(a) for a in sys.argv[1:5])
store, outdir, case, bn_remat = sys.argv[5], sys.argv[6], sys.argv[7], sys.argv[8] == "1"
device = sys.argv[9] if len(sys.argv) > 9 else "cpu"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
os.chdir(os.path.dirname(HERE))     # plans name cfg/net/... from the repo root

import torch  # noqa: E402

torch.set_num_threads(2)

import _torch_port as TP  # noqa: E402
from yolo_continuous_tpu_torch.config.plan import TrainPlan  # noqa: E402
from yolo_continuous_tpu_torch.parallel import distributed as dist  # noqa: E402
from yolo_continuous_tpu_torch.parallel.mesh import (gather_params, make_mesh,  # noqa: E402
                                                     shard_batch, shard_params)
from yolo_continuous_tpu_torch.train.train_loop import Trainer  # noqa: E402

GLOBAL_BS = 4


def main():
    if device == "cuda":
        import datetime
        torch.distributed.init_process_group("gloo", init_method=f"file://{store}",
                                             world_size=world, rank=rank,
                                             timeout=datetime.timedelta(seconds=60))
    else:
        dist.initialize(f"file://{store}", world, rank, device="cpu", timeout_s=60)
    assert dist.process_count() == world and dist.process_index() == rank
    mesh = make_mesh(n_data, n_model, devices=device)
    assert dist.local_batch_size(GLOBAL_BS, mesh) == GLOBAL_BS // n_data
    plan = TrainPlan(dict(TP.dist_plan_cfg(case, GLOBAL_BS), bn_remat=bn_remat))
    trainer = Trainer(plan, device=device, dtype=torch.float32, mesh=mesh)
    state = trainer.init_state(seed=0)
    min_channels = TP.SHARD_MIN_CHANNELS if case == "shallow" else 64
    shard_params(mesh, state, min_channels=min_channels)
    batch = shard_batch(mesh, TP.dist_batch(GLOBAL_BS))
    state, metrics = trainer.train_step(state, *batch, 0.01, 0.1, 0.9)
    full = gather_params(mesh, state)
    if rank == 0:
        to_cpu = {"model": {k: v.cpu() for k, v in full["model"].items()},
                  "ema": {"tree": {k: v.cpu() for k, v in full["ema"]["tree"].items()},
                          "updates": full["ema"]["updates"]}, "step": full["step"]}
        torch.save({"metrics": {k: v.cpu() for k, v in metrics.items()}, "state": to_cpu,
                    "shards": state["model"].shards}, os.path.join(outdir, "result.pt"))
    dist.shutdown()
    print(f"rank {rank}: loss {float(metrics['loss']):.6f}", flush=True)


if __name__ == "__main__":
    main()
