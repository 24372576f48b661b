"""Data-parallel dry run on tiny shapes (the counterpart of
`__graft_entry__.dryrun_multichip`).

    python -m eigentrajectory_tpu_torch.parallel.dryrun --n 4 [--device cpu] [--share_card]

Spawns n ranks: gloo on the CPU; on the card NCCL with a card a rank, or,
with `--share_card`, gloo with every rank on cuda:0. Each rank builds the
same tiny ET-STGCNN and ET-PECNet trainers on synthetic splits and runs one
sequenced step, a sharded `test()`, one collated epoch and a sharded packed
`test()`. Rank 0 prints the line the JAX dry run prints:

    dryrun_multichip(4): ok, loss=..., collated_loss=..., eval ADE seq=... col=...
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch
import torch.multiprocessing as mp

from ..config import ExpConfig
from ..data.batching import pad_scenes
from ..data.synthetic import make_synthetic_data
from ..train.trainer import ETTorchTrainer
from . import mesh


def _tiny_trainer(device, root, batch_size, n_scenes, baseline="stgcnn", world=1):
    cfg = ExpConfig(baseline=baseline, batch_size=batch_size, dataset="synthetic",
                    checkpoint_dir=root, mesh_data_axis=world)
    data = tuple(make_synthetic_data(n_scenes=n_scenes, seed=s) for s in (0, 1, 2))
    tr = ETTorchTrainer(cfg, tag=f"dryrun-{baseline}", datasets=data, device=device)
    tr.init_descriptor()
    return tr


def _rank(rank, n, init_method, device, share_card, root):
    if device == "cpu":                 # the host's cores shared among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    group = mesh.init_process_group(rank, n, init_method, device=device, share_card=share_card)
    try:
        batch = max(n, 4) if max(n, 4) % n == 0 else n
        tr = _tiny_trainer(device, root, batch, 2 * batch, world=n)
        tr.model.train()
        args, part = tr.step_args(pad_scenes(tr.data_train, list(range(batch)), tr.n_max, batch))
        loss = float(tr.train_step(*args, part=part))
        tr.model.eval()
        if not math.isfinite(loss):
            raise AssertionError(f"multichip dryrun produced non-finite loss {loss}")
        m_seq = _tiny_trainer(device, root, n, 2 * batch, world=n).test(eval_batch=n)
        tr_col = _tiny_trainer(device, root, 2 * n, 4 * n, baseline="pecnet", world=n)
        loss_col = tr_col.train(0)
        m_col = tr_col.test(eval_ped_batch=2 * n)
        if not all(math.isfinite(x) for x in (loss_col, m_seq["ADE"], m_col["ADE"])):
            raise AssertionError(f"non-finite results {loss_col} {m_seq} {m_col}")
        if rank == 0:
            print(f"dryrun_multichip({n}): ok, loss={loss:.6f}, collated_loss={loss_col:.6f}, "
                  f"eval ADE seq={m_seq['ADE']:.4f} col={m_col['ADE']:.4f} "
                  f"[{group.backend} on {group.device.type}]", flush=True)
    finally:
        mesh.destroy()


def dryrun(n: int, device: str = "cuda", share_card: bool = False):
    """Run the dry run over n spawned ranks; raises if a rank fails."""
    with tempfile.TemporaryDirectory() as root:
        mp.spawn(_rank, args=(n, f"file://{os.path.join(root, 'init')}", device, share_card,
                              root), nprocs=n)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=4, help="ranks")
    parser.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    parser.add_argument("--share_card", action="store_true",
                        help="put every rank on cuda:0 (gloo, collectives through the host)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the ranks on the CPU")
    dryrun(args.n, args.device, args.share_card)


if __name__ == "__main__":
    main()
