"""Data parallelism: the device list of a single-process predictor and the
process group of a training run.

The counterpart of `eigentrajectory_tpu/parallel/mesh.py`. The JAX package
runs one SPMD program over a ('data', 'model') mesh and lets XLA insert the
gradient all-reduce. Here a data-parallel run is one process a rank
(`torchrun --nproc_per_node=N`, or `torch.multiprocessing.spawn`), each with
the whole split on its host; the trainer plans every rank's shard the same
way and sums the gradients with one `all_reduce_sum_` a step. A
single-process `ETPredictor` spreads a request's rows over `make_mesh()`'s
devices instead.

Backends: NCCL where every rank has a card of its own (`cuda:LOCAL_RANK`);
gloo on the CPU, or where the caller asks for ranks that share one card
(`share_card=True`, or `ET_SHARE_CARD=1` for `init_from_env`). Then every
kernel and every model op still runs on the card, and the collectives go
through the host. The backend taken is printed; there is no quiet fallback.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..data.batching import slot_width
from ..utils.profiling import span


def make_mesh(n_data: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices a single-process `ETPredictor(mesh=)` spreads rows over:
    the named `devices` (a device may be named more than once: one replica
    each), or the first `n_data` cards (all visible cards by default).
    Raises where fewer cards exist than asked."""
    if devices is not None:
        mesh = [torch.device(d) for d in devices]
        if n_data is not None and n_data != len(mesh):
            raise ValueError(f"n_data = {n_data} for {len(mesh)} named devices")
        for d in mesh:
            if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
                raise ValueError(f"{d} named, {torch.cuda.device_count()} cards visible")
        return mesh
    have = torch.cuda.device_count()
    n = have if n_data is None else n_data
    if n < 1 or n > have:
        raise ValueError(f"need {n} cards, have {have}; name the devices to share one")
    return [torch.device("cuda", i) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class Rank:
    """This process's place in the data-parallel run."""

    rank: int
    world: int
    device: torch.device
    backend: str


_RANK: Optional[Rank] = None


def init_process_group(rank: int, world: int, init_method: str, device: str = "cuda",
                       local_rank: Optional[int] = None, local_world: Optional[int] = None,
                       share_card: bool = False) -> Rank:
    """Join a process group of `world` ranks at `init_method` (`env://`,
    `tcp://host:port` or `file://path`) and pick this rank's device and
    backend: gloo on the CPU; on the card NCCL with `cuda:local_rank`
    (`local_rank` defaults to `rank`), or gloo with every rank on the card
    `device` names (cuda:0 by default) when `share_card`. A rank that finds
    no card raises, and so does every rank where the host's `local_world`
    ranks (default `world`) outnumber its cards without `share_card`,
    before any of them waits for the others."""
    global _RANK
    want = torch.device(device)
    local_rank = rank if local_rank is None else local_rank
    if want.type == "cpu":
        backend, dev = "gloo", want
    elif want.type != "cuda":
        raise ValueError(f"data-parallel ranks run on 'cuda' or 'cpu', got {device}")
    elif not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: no CUDA device; pass device='cpu' to run on the CPU")
    elif share_card:
        backend, dev = "gloo", torch.device("cuda", want.index or 0)
    else:
        local_world = world if local_world is None else local_world
        if max(local_world, local_rank + 1) > torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: {local_world} ranks on this host need a card of its own each "
                f"and {torch.cuda.device_count()} are visible; ask for share_card to put "
                f"ranks on one card (gloo)")
        backend, dev = "nccl", torch.device("cuda", local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kwargs)
    _RANK = Rank(rank, world, dev, backend)
    if rank == 0:
        how = ("ranks share one card, collectives through the host"
               if backend == "gloo" and dev.type == "cuda" else
               "a card a rank" if backend == "nccl" else "CPU")
        print(f"[parallel] backend {backend}, world {world}, rank 0 on {dev} ({how})",
              flush=True)
    return _RANK


def init_from_env(device: str = "cuda", share_card: Optional[bool] = None) -> Rank:
    """`init_process_group` from torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT. `share_card` None reads
    ET_SHARE_CARD (1: the ranks share one card through gloo)."""
    if share_card is None:
        share_card = os.environ.get("ET_SHARE_CARD", "0") == "1"
    world = int(os.environ["WORLD_SIZE"])
    return init_process_group(int(os.environ["RANK"]), world, "env://", device=device,
                              local_rank=int(os.environ.get("LOCAL_RANK", 0)),
                              local_world=int(os.environ.get("LOCAL_WORLD_SIZE", world)),
                              share_card=share_card)


def current() -> Optional[Rank]:
    """This process's rank in the group `init_process_group` joined, or None."""
    return _RANK if _RANK is not None and dist.is_initialized() else None


def destroy():
    """Leave the process group."""
    global _RANK
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK = None


def _through_host(x: torch.Tensor) -> bool:
    """Gloo takes host tensors only: a card tensor goes through a copy."""
    return _RANK.backend == "gloo" and x.device.type == "cuda"


def all_reduce_sum_(buf: torch.Tensor) -> torch.Tensor:
    """Sum `buf` over the ranks in place (one collective). Under gloo a card
    tensor goes through a host copy."""
    if _through_host(buf):
        host = buf.cpu()
        dist.all_reduce(host)
        buf.copy_(host)
    else:
        dist.all_reduce(buf)
    return buf


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's (B, L, C) tensor stacked, (world, B, L, C).
    Backward: the sum over the ranks of the gradient of this rank's block.
    One all-gather forward and one all-reduce backward, the same
    collectives under gloo (a card tensor through a host copy) and NCCL."""

    @staticmethod
    def forward(ctx, x):
        with span("train.all_gather"):
            src = (x.cpu() if _through_host(x) else x).detach().contiguous()
            parts = [torch.empty_like(src) for _ in range(_RANK.world)]
            dist.all_gather(parts, src)
            return torch.stack(parts).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        with span("train.all_gather"):
            # A copy: the reduction is in place, and `grad` is autograd's.
            buf = (grad.cpu().contiguous() if _through_host(grad) else
                   grad.clone(memory_format=torch.contiguous_format))
            dist.all_reduce(buf)
            return buf[_RANK.rank].to(grad.device)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, L, C) on every rank (L equal on all) -> (world, B, L, C), rank r's
    tensor at [r]; differentiable: each rank's gradient is the sum over the
    ranks of the gradient that reaches its block. Every rank must call it,
    in the same order."""
    if current() is None:
        raise RuntimeError("all_gather_rows needs a process group (init_process_group)")
    return _GatherRows.apply(x)


@dataclasses.dataclass(frozen=True)
class SlotShard:
    """A rank's share of a packed row of `slots` pedestrian slots in a
    data-parallel training step: the contiguous slots [lo, lo + width),
    width = ceil(slots / world), the last rank's padded past the row's end
    (JAX's even split of the flat pedestrian axis).

    For a forward over time-major tokens (token t * slots + a is slot a at
    step t), a rank holds its slots' tokens t * width + i and reads every
    rank's through `gather`, in the single process's order.
    """

    rank: int
    world: int
    slots: int

    @property
    def width(self) -> int:
        return slot_width(self.slots, self.world)

    @property
    def lo(self) -> int:
        return self.rank * self.width

    def own_slots(self, device) -> torch.Tensor:
        """(width,) int64: the row's slot of each of this rank's slots, the
        padding past the row's end at its last slot (whose masks and draws
        it then takes: finite, and dropped with the padding's outputs)."""
        return torch.clamp_max(torch.arange(self.lo, self.lo + self.width, device=device),
                               self.slots - 1)

    def token_rows(self, t_len: int, device) -> torch.Tensor:
        """(t_len * width,) int64: the single process's token of each of this
        rank's `t_len` steps' tokens."""
        steps = torch.arange(t_len, device=device)[:, None] * self.slots
        return (steps + self.own_slots(device)[None, :]).reshape(-1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T * width, C), this rank's tokens -> (B, T * slots, C), every
        rank's in the single process's order (the padding past the row's
        end dropped); differentiable (`all_gather_rows`)."""
        b, length, c = x.shape
        t_len = length // self.width
        every = all_gather_rows(x).reshape(self.world, b, t_len, self.width, c)
        every = every.permute(1, 2, 0, 3, 4).reshape(b, t_len, self.world * self.width, c)
        return every[:, :, :self.slots].reshape(b, t_len * self.slots, c)


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src` on every rank (pickled; keep it small and on the
    host)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src,
                               device=_RANK.device if _RANK.backend == "nccl" else None)
    return box[0]


def barrier():
    if _RANK.backend == "nccl":
        dist.barrier(device_ids=[_RANK.device.index])
    else:
        dist.barrier()
