"""Shared building blocks for the predictors.

The counterparts of the layers in `eigentrajectory_tpu/models/common.py`.
Tensors carry the scene axis first: where the JAX package calls a layer on
one (1, C, H, W) scene under `vmap`, these layers take a (B, C, H, W) block
with one scene per batch row and a (B, W) pedestrian validity mask.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

_Pair = Union[int, Tuple[int, int]]


class TorchConv2d(nn.Conv2d):
    """Conv2d over NCHW with OIHW `weight` and `bias`; torch's default init,
    the one the JAX layer reproduces."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: _Pair,
                 stride: _Pair = 1, padding: _Pair = 0, dilation: _Pair = 1,
                 use_bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=use_bias)


class PReLU(nn.Module):
    """PReLU with one shared slope, `where(x >= 0, x, a * x)`."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


class MaskedBatchNorm2d(nn.Module):
    """BatchNorm2d over (B, C, H, W) scene blocks with a (B, W) ped mask.

    Eval mode normalizes with the running statistics. Train mode normalizes
    each scene with its own biased statistics over (H, valid W), as the JAX
    layer does on one vmapped scene, and moves the running statistics
    (momentum 0.1, unbiased variance) to the mean of the per-scene updates
    weighted by scene validity, as the JAX trainer averages them: a scene
    counts if it has a valid pedestrian (every scene, without a mask), so
    the padding rows of a block's tail do not pull the statistics toward
    their zeros. The divisor is max(valid scenes, 1).

    One forward is one update from the statistics it finds. A caller that
    splits a step into chunks restores the pre-step statistics before each
    chunk and averages the chunks' results (`ETTorchTrainer.loss_and_grads`);
    letting the chunks update in turn would compound the momentum.
    """

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            mean = self.running_mean[None, :, None, None]
            var = self.running_var[None, :, None, None]
        else:
            if mask is None:
                m = torch.ones_like(x[:, :1, :1, :])
            else:
                m = mask.to(x.dtype)[:, None, None, :]           # (B, 1, 1, W)
            peds = m.sum(dim=3, keepdim=True)                    # (B, 1, 1, 1)
            cnt = x.shape[2] * torch.clamp_min(peds, 1.0)
            mean = (x * m).sum(dim=(2, 3), keepdim=True) / cnt   # (B, C, 1, 1)
            var = (((x - mean) ** 2) * m).sum(dim=(2, 3), keepdim=True) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp_min(cnt - 1.0, 1.0)
                w = (peds > 0).to(x.dtype)                       # scene validity
                wsum = torch.clamp_min(w.sum(), 1.0)
                m_ = self.momentum
                for stat, new in ((self.running_mean, mean), (self.running_var, unbiased)):
                    per_scene = (1 - m_) * stat[None, :] + m_ * new[:, :, 0, 0]   # (B, C)
                    stat.copy_((per_scene * w[:, :, 0, 0]).sum(dim=0) / wsum)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * inv * self.weight[None, :, None, None] + \
            self.bias[None, :, None, None]


class Dropout(nn.Module):
    """Dropout as flax's `nn.Dropout`: each element kept where a uniform draw
    is >= `rate` and scaled by 1 / (1 - rate), zeroed elsewhere; the identity
    in eval mode.

    The draws come from `generator` alone, which the trainer sets
    (`set_dropout_generator`), never from torch's global stream, so that a
    run is made by its seed and resumes exactly. A module in train mode
    without a generator raises.
    """

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor, rows: Optional[Tuple[torch.Tensor, int]] = None,
                dim: int = 1) -> torch.Tensor:
        """`rows` = (index, length): `x` holds the rows `index` along `dim` of
        a tensor of `length` rows there (a data-parallel rank's share of a
        token axis). The whole tensor's mask is drawn and `x`'s rows taken,
        so the draws and the generator's state are the single process's."""
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator: "
                               "set_dropout_generator(model, generator)")
        shape = x.shape if rows is None else x.shape[:dim] + (rows[1],) + x.shape[dim + 1:]
        keep = torch.rand(shape, generator=self.generator, device=x.device,
                          dtype=x.dtype) >= self.rate
        if rows is not None:
            keep = keep.index_select(dim, rows[0])
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator: torch.Generator):
    """Have every `Dropout` of `model` draw from `generator`."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator = generator


class DropEdge(nn.Module):
    """DropEdge over a block of multi-relational adjacencies (B, R, T, N, N):
    each edge kept where a uniform draw is <= `percent`, zeroed elsewhere,
    and NOT rescaled; the identity in eval mode.

    The JAX layer draws from one key per scene. Here the caller sets `keep`,
    the kept-edge mask of the rows it runs (`draw_edge_keeps`), before a
    train-mode forward: the trainer draws it for the whole block once a step
    from its `dropout_generator`, so a scene's draws do not depend on how the
    block is chunked. The mask is a plain attribute, not a buffer: it is no
    checkpoint leaf. A module in train mode without a mask raises.
    """

    def __init__(self, relation: int, seq_len: int, percent: float = 0.8):
        super().__init__()
        self.relation = relation
        self.seq_len = seq_len
        self.percent = percent
        self.keep: Optional[torch.Tensor] = None

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return a
        if self.keep is None:
            raise RuntimeError("DropEdge in train mode needs its kept-edge mask: "
                               "set_edge_keeps(model, draw_edge_keeps(model, ...))")
        if self.keep.shape != a.shape:
            raise ValueError(f"DropEdge mask {tuple(self.keep.shape)} for an adjacency "
                             f"{tuple(a.shape)}")
        return a * self.keep.to(a.dtype)


def drop_edge_layers(model: nn.Module):
    """The `DropEdge` layers of `model`, in module order."""
    return [m for m in model.modules() if isinstance(m, DropEdge)]


def draw_edge_keeps(model: nn.Module, generator: torch.Generator, rows: int,
                    slots: int):
    """One kept-edge mask (rows, R, T, slots, slots) for each DropEdge layer
    of `model`, in module order, drawn as float32 uniforms from `generator`
    on its device: the same masks whatever the dtype of the model."""
    return [torch.rand((rows, m.relation, m.seq_len, slots, slots), generator=generator,
                       device=generator.device, dtype=torch.float32) <= m.percent
            for m in drop_edge_layers(model)]


def set_edge_keeps(model: nn.Module, keeps):
    """Hand each DropEdge layer of `model` its mask, in module order (None or
    an empty list clears them all)."""
    layers = drop_edge_layers(model)
    if keeps and len(keeps) != len(layers):
        raise ValueError(f"{len(keeps)} DropEdge masks for {len(layers)} layers")
    for i, m in enumerate(layers):
        m.keep = keeps[i] if keeps else None


class TorchMLP(nn.Module):
    """PECNet / LB-EBM style MLP: `nn.Linear` layers `layer_0`, `layer_1`,
    ... (the JAX module's names), ReLU between them, an optional sigmoid at
    the end (`discrim`), and `Dropout` after each hidden ReLU unless
    `dropout` is -1 (rate min(0.1, dropout / 3) after the second layer,
    `dropout` elsewhere; active in train mode only)."""

    def __init__(self, in_features: int, hidden: Sequence[int], out_features: int,
                 discrim: bool = False, dropout: float = -1.0):
        super().__init__()
        dims = [in_features, *hidden, out_features]
        self.n_layers = len(dims) - 1
        for i in range(self.n_layers):
            self.add_module(f"layer_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.discrim = discrim
        self.drops = nn.ModuleList(
            Dropout(min(0.1, dropout / 3) if i == 1 else dropout)
            for i in range(self.n_layers - 1)) if dropout != -1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x)
            if i != self.n_layers - 1:
                x = torch.relu(x)
                if self.drops is not None:
                    x = self.drops[i](x)
            elif self.discrim:
                x = torch.sigmoid(x)
        return x


def zero_invalid(x: torch.Tensor, valid: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero features at invalid ped slots: x (B, ...) with the ped axis at
    `axis`, valid (B, N) bool."""
    shape = [1] * x.ndim
    shape[0] = x.shape[0]
    shape[axis] = x.shape[axis]
    return x * valid.to(x.dtype).reshape(shape)
