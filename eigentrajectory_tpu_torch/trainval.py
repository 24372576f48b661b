"""CLI entry point of the port (the counterpart of the repository's
`trainval.py`).

Usage:
  python -m eigentrajectory_tpu_torch.trainval --cfg configs/eigentrajectory-stgcnn-hotel.json --tag mytag
  python -m eigentrajectory_tpu_torch.trainval --cfg ... --test
  python -m eigentrajectory_tpu_torch.trainval --cfg ... --device cpu

Training fits the descriptor, trains with best-val checkpointing, reloads the
best checkpoint and evaluates it. It runs on the card unless `--device cpu`.

Data-parallel, with a config whose `mesh_data_axis` is N:
  torchrun --nproc_per_node=N -m eigentrajectory_tpu_torch.trainval --cfg ...
Each rank takes a card of its own (NCCL); `ET_SHARE_CARD=1` puts the ranks
on one card (gloo, collectives through the host), `--device cpu` on the CPU
(gloo). A WORLD_SIZE other than `mesh_data_axis` is refused. Rank 0 prints
and writes the checkpoints.
"""
import argparse
import os

from . import parallel
from .config import load_config
from .train.trainer import ETTorchTrainer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default="./configs/eigentrajectory-stgcnn-eth.json",
                        type=str, help="config file path")
    parser.add_argument("--tag", default="EigenTrajectory-TPU-TEMP", type=str,
                        help="personal tag for the model")
    parser.add_argument("--test", default=False, action="store_true",
                        help="evaluation mode")
    parser.add_argument("--epochs", default=None, type=int,
                        help="override number of epochs")
    parser.add_argument("--resume", default=False, action="store_true",
                        help="resume from resume.pt (full optimizer state)")
    parser.add_argument("--ckpt_every", default=0, type=int,
                        help="write resume state every N epochs")
    parser.add_argument("--baseline", default=None, type=str,
                        help="override baseline name")
    parser.add_argument("--dataset_dir", default=None, type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device; the card unless 'cpu' is asked for")
    args = parser.parse_args(argv)

    overrides = {}
    if args.baseline:
        overrides["baseline"] = args.baseline
    if args.dataset_dir:
        overrides["dataset_dir"] = args.dataset_dir
    cfg = load_config(args.cfg, **overrides)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != cfg.mesh_data_axis:
        raise SystemExit(f"WORLD_SIZE {world} differs from the config's mesh_data_axis "
                         f"{cfg.mesh_data_axis}: run torchrun --nproc_per_node="
                         f"{cfg.mesh_data_axis}, or set mesh_data_axis to {world}")
    rank = parallel.init_from_env(device=args.device).rank if world > 1 else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        say(f"Config: {cfg}", flush=True)
        trainer = ETTorchTrainer(cfg, tag=args.tag, device=args.device)
        if not args.test:
            trainer.init_descriptor()
            trainer.fit(num_epochs=args.epochs, resume=args.resume,
                        checkpoint_every=args.ckpt_every)
            trainer.load_model()
            results = trainer.test()
        else:
            trainer.load_model()
            say("Testing...", end=" ")
            results = trainer.test()
        say(f"Scene: {cfg.dataset}",
            *[f"{k}: {v:.8f}" for k, v in results.items()], flush=True)
        return results
    finally:
        if world > 1:
            parallel.destroy()


if __name__ == "__main__":
    main()
