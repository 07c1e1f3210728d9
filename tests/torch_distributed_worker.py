"""One process of ``tests/test_torch_distributed.py``'s two-process gloo
group on the CPU.

    python tests/torch_distributed_worker.py RANK ADDRESS_A ADDRESS_B WORKDIR

1. ``cli.train`` with ``--coordinator_address ADDRESS_A --num_processes 2
   --process_id RANK --device cpu --profile_dir``: one profiled epoch and
   one more (the JAX CLI's order), on ``WORKDIR/config_RANK.yaml``, whose
   ``root_dir`` is ``WORKDIR/rRANK``;
2. a second group at ``ADDRESS_B``: the loader's shard of a 12-sample
   epoch at the global batch 4, ``gather_batch`` of a rank-valued tensor,
   and for each OHEM reduction a train step (``build_train_step`` through
   ``DistributedDataParallel``) on this process's half of the global batch
   ``text_batch(SEED, 4, 64)``, from the seeded weights.

Writes ``WORKDIR/worker_RANK.pt``: the shard, the gathered values, cli.train's
history, and per reduction the step's losses and each parameter's
gradient."""

import os
import sys

import torch

rank, address_a, address_b, workdir = (int(sys.argv[1]), sys.argv[2],
                                       sys.argv[3], sys.argv[4])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
torch.set_num_threads(2)

from db_text_minimal_tpu_torch import parallel  # noqa: E402
from db_text_minimal_tpu_torch.cli import train as train_cli  # noqa: E402
from db_text_minimal_tpu_torch.data.datasets import DataLoader  # noqa: E402
from db_text_minimal_tpu_torch.data.scenes import text_batch  # noqa: E402
from db_text_minimal_tpu_torch.train import trainer as T  # noqa: E402

SEED, LR = 5, 0.005


class IndexDataset:
    def __len__(self):
        return 12


def step_config(reduction: str):
    from db_text_minimal_tpu_torch.config import default_config

    cfg = default_config()
    cfg.meta.device = "cpu"
    cfg.hps.img_size = 64
    cfg.hps.batch_size = 4
    cfg.optimizer.reduction = reduction
    return cfg


_, history = train_cli.main(train_cli.load_args(
    ["--config", os.path.join(workdir, f"config_{rank}.yaml"), "--epochs",
     "1", "--device", "cpu", "--coordinator_address", address_a,
     "--num_processes", "2", "--process_id", str(rank), "--profile_dir",
     os.path.join(workdir, f"r{rank}", "profile")]))
assert not torch.distributed.is_initialized()

parallel.initialize_distributed(address_b, 2, rank, "cpu")
assert parallel.world_size() == 2 and parallel.rank() == rank
per_process = parallel.local_batch_slice(4)
loader = DataLoader(IndexDataset(), per_process, shuffle=True, seed=123,
                    num_hosts=2, host_id=rank, prefetch=0, num_workers=1)
out = {"seen": [int(i) for i in loader._indices()], "len": len(loader),
       "gathered": parallel.gather_batch(
           torch.tensor([float(rank + 1)])).tolist(),
       "history": history}
batch = text_batch(SEED, 4, 64)
local = {k: v[rank * per_process:(rank + 1) * per_process]
         for k, v in T.array_batch(batch).items()}
for reduction in ("mean", "none"):
    cfg = step_config(reduction)
    state = T.Trainer(cfg).init_state()
    assert isinstance(state.ddp,
                      torch.nn.parallel.DistributedDataParallel)
    state, loss, hist, preds = T.build_train_step(cfg)(
        state, T.to_device(local, torch.device("cpu")), LR)
    out[reduction] = {
        "loss": [float(v) for v in loss], "hist": hist.tolist(),
        "preds_shape": list(preds.shape),
        "grads": {n: p.grad.clone()
                  for n, p in state.model.named_parameters()},
        "running_var": {k: v.clone() for k, v in
                        state.model.state_dict().items()
                        if k.endswith("running_var")}}
torch.save(out, os.path.join(workdir, f"worker_{rank}.pt"))
torch.distributed.destroy_process_group()
print("WORKER_OK", rank)
