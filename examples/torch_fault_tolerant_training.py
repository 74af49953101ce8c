"""Fault-tolerant training demo on the PyTorch port: inject host failures
mid-run, watch the supervisor restore from checkpoint, re-mesh over the
survivors and finish (``examples/fault_tolerant_training.py``'s run).

Eight logical hosts run on the ranks of the process group (host h on rank
h mod the world size).  After each failure every rank rebuilds the session
over a mesh of the ranks that still run a host
(``runtime.survivor_mesh``), the checkpoint is restored onto it, each
rank keeping its part, and training resumes at the checkpoint's step; a
rank whose hosts are all lost leaves the mesh and only follows the
failure schedule.

Runs on the CUDA card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_fault_tolerant_training.py
      PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
          examples/torch_fault_tolerant_training.py --device cpu
"""

import argparse
import tempfile

import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.data import MarkovLMConfig, MarkovLMDataset, ShardedLoader
from repro_torch.launch.mesh import init_ranks
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime import (HostSet, StragglerMonitor, Supervisor,
                                 TrainConfig, Trainer, survivor_mesh)


def say(*args, **kwargs):
    if dist.get_rank() == 0:
        print(*args, **kwargs)


class Session:
    def __init__(self, ckpt_dir, n_hosts, hosts, device):
        cfg = get_smoke("qwen2-0.5b")
        mesh = survivor_mesh(hosts, device)
        self.active = mesh.get_coordinate() is not None
        self.idle_step = 0
        if self.active:
            self.tr = Trainer(build_model(cfg), AdamW(learning_rate=2e-3),
                              device, TrainConfig(log_every=100),
                              ckpt=CheckpointManager(ckpt_dir,
                                                     save_interval=5),
                              mesh=mesh)
            self.loader = ShardedLoader(MarkovLMDataset(MarkovLMConfig(
                vocab_size=cfg.vocab_size, seq_len=32, batch_size=8)),
                device=device, mesh=mesh)
        self.n_hosts = n_hosts
        say(f"  [session] built over {n_hosts} hosts")

    @property
    def step(self):
        return self.tr.step if self.active else self.idle_step

    def run_until(self, target, hosts):
        if not self.active:
            # this rank's hosts are gone: keep to the failure schedule, so
            # the next re-mesh finds every rank of the group
            while self.idle_step < target:
                hosts.check(self.idle_step)
                self.idle_step += 1
            return
        params, opt, err = self.tr.init_state(0)
        params, opt, err, start = self.tr.maybe_restore(params, opt, err)
        if start:
            say(f"  [session] restored checkpoint at step {start}")
        self.loader.seek(start)
        self.tr.build_step(self.loader.peek_structure())
        state = (params, opt, err)
        while self.tr.step < target:
            hosts.check(self.tr.step)
            state, hist = self.tr.fit(self.loader, 1, state=state)
            if self.tr.step % 5 == 0:
                say(f"  step {self.tr.step:3d}  "
                    f"loss {hist[-1]['loss']:.4f}")
                self.tr.ckpt.save(self.tr.step,
                                  {"params": state[0], "opt": state[1],
                                   "err": state[2]},
                                  metadata={"data_step": self.tr.step})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    device = init_ranks(args.device)
    with tempfile.TemporaryDirectory() as d:
        # every rank writes into rank 0's directory
        dirs = [d]
        dist.broadcast_object_list(dirs, src=0)
        hosts = HostSet(n_hosts=8, fail_at={12: 5, 23: 2})
        say("cluster: 8 hosts; failures injected at steps 12 and 23\n")
        sup = Supervisor(lambda n: Session(dirs[0], n, hosts, device), hosts,
                         monitor=StragglerMonitor(factor=3.0))
        report = sup.run(target_steps=30)
        say(f"\nfinished at step {report.final_step}: "
            f"{report.restarts} restarts after losing hosts "
            f"{report.failures}; mesh sizes {report.remesh_history}")
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
