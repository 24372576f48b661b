"""ET-Social-Implicit: speed-zone-routed conv cells in ET coefficient space.

The counterpart of `eigentrajectory_tpu/models/implicit.py`
(`SocialImplicitLight`): pedestrians fall into "social zones" by |c_0|, the
magnitude of their first ET coefficient, against BINS, and each zone's
pedestrians go through that zone's SocialCellGlobal (a 2D conv stream over
(time, pedestrian) plus a per-pedestrian 1D stream, fused by learned
scalars). Noise is off (KSTEPS = 1): `noise_w` exists as a parameter and the
Light model never uses it. ET wiring: spatial 1 -> s, temporal k+2 -> k.

The global cell's 3x3 convs mix *adjacent pedestrians of the zone's
compacted order*. So each scene's zone members are moved to the front of
the row in slot order (a stable compaction by an integer key), the cell
runs on the whole masked row, and its output is scattered back. All four
cells run on every block, as the JAX model runs them, so an empty zone's
parameters still get a zero gradient (and their weight decay).

The full `SocialImplicit` (two channels, KSTEPS samples from a shared
N(0, I) draw scaled per zone by `noise_w` and NOISE_WEIGHT) never runs in
the ET pipeline; it is the counterpart of the JAX package's dormant module,
held against it by tests/test_torch_dormant.py.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .common import TorchConv2d, zero_invalid

BINS = (0.0, 0.01, 0.1, 1.2)
NOISE_WEIGHT = (0.05, 1, 4, 8)


class Conv1dTorch(nn.Module):
    """Conv1d over (M, C, L) as a (k, 1) Conv2d named `conv`, the JAX
    module's layout."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0):
        super().__init__()
        self.conv = TorchConv2d(in_channels, out_channels, (kernel_size, 1),
                                padding=(padding, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x[..., None])[..., 0]


class SocialCellLocal(nn.Module):
    """Per-pedestrian 1D conv streams (no mixing of pedestrians)."""

    def __init__(self, spatial_input: int, spatial_output: int, temporal_input: int,
                 temporal_output: int):
        super().__init__()
        self.shape = (spatial_input, spatial_output, temporal_input, temporal_output)
        self.highway_input = Conv1dTorch(spatial_input, spatial_output, 1)
        self.feat = Conv1dTorch(spatial_input, spatial_output, 3, padding=1)
        self.highway = Conv1dTorch(temporal_input, temporal_output, 1)
        self.tpcnn = Conv1dTorch(temporal_input, temporal_output, 3, padding=1)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        # (B, C, T, V) -> (B*V, C, T)
        si, so, ti, to = self.shape
        b, _, _, n = v.shape
        h = v.permute(0, 3, 1, 2).reshape(b * n, si, ti)
        h = torch.relu(self.feat(h)) + self.highway_input(h)
        h = h.transpose(1, 2)                                    # (B*V, T, C_out)
        h = self.tpcnn(h) + self.highway(h)                      # (B*V, T_out, C_out)
        # a raw reinterpretation to (B, V, C_out, T_out), as the JAX model's reshape
        return h.reshape(b, n, so, to).permute(0, 2, 3, 1)       # (B, C_out, T_out, V)


class SocialCellGlobal(nn.Module):
    """2D conv global stream + the local stream, fused by learned scalars."""

    def __init__(self, spatial_input: int, spatial_output: int, temporal_input: int,
                 temporal_output: int):
        super().__init__()
        self.noise_w = nn.Parameter(torch.zeros(1))
        self.global_w = nn.Parameter(torch.zeros(1))
        self.local_w = nn.Parameter(torch.zeros(1))
        self.ped = SocialCellLocal(spatial_input, spatial_output, temporal_input,
                                   temporal_output)
        self.highway_input = TorchConv2d(spatial_input, spatial_output, (1, 1))
        self.feat = TorchConv2d(spatial_input, spatial_output, (3, 3), padding=(1, 1))
        self.highway = TorchConv2d(temporal_input, temporal_output, (1, 1))
        self.tpcnn = TorchConv2d(temporal_input, temporal_output, (3, 3), padding=(1, 1))

    def forward(self, v: torch.Tensor, valid: torch.Tensor, noise: Optional[torch.Tensor] = None,
                noise_scale: float = 1.0) -> torch.Tensor:
        # v (B, C, T, V), valid (B, V) -> (B, C_out, T_out, V). With `noise`
        # (KSTEPS, C, 1, 1) a row of one scene becomes KSTEPS samples of it,
        # each with noise_w * noise_scale * its draw added to the input.
        if noise is not None:
            v = v + self.noise_w * noise_scale * noise
            valid = valid.expand(v.shape[0], -1)
        v_ped = self.ped(v)
        v = zero_invalid(v, valid, 3)
        h = torch.relu(self.feat(v)) + self.highway_input(v)
        h = zero_invalid(h.transpose(1, 2), valid, 3)            # (B, T, C, V)
        h = (self.tpcnn(h) + self.highway(h)).transpose(1, 2)    # (B, C, T_out, V)
        return self.global_w * h + self.local_w * v_ped


def zones(v: torch.Tensor) -> torch.Tensor:
    """(B, V) zone of each pedestrian: the number of BINS at or below the
    inf-norm over the channels at t = 0 (|c_0| for one channel), less one,
    in [0, len(BINS) - 1]."""
    bins = torch.tensor(BINS, dtype=v.dtype, device=v.device)
    norm = v[:, :, 0, :].abs().amax(dim=1)
    zone = (norm[:, None, :] >= bins[None, :, None]).sum(dim=1) - 1
    return zone.clamp(0, len(BINS) - 1)


def compaction(sel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, inverse) of each row of sel (B, V) bool: the selected slots
    first, each part in slot order. Sorting the distinct integer keys
    slot (selected) and slot + V (not) makes the order stable without
    relying on a stable sort of bools."""
    n = sel.shape[1]
    slots = torch.arange(n, device=sel.device)
    order = torch.argsort(torch.where(sel, slots, slots + n), dim=1)
    return order, torch.argsort(order, dim=1)


def route_by_zone(cells: Sequence[SocialCellGlobal], v: torch.Tensor, valid: torch.Tensor,
                  out_shape: Tuple[int, ...],
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each zone's pedestrians through its cell: moved to the front of the
    row (`compaction`), the cell run on the masked row, the output scattered
    back. v (B, C, T, V), valid (B, V) -> out_shape (B', C_out, T_out, V),
    B' = KSTEPS where `noise` (KSTEPS, C, 1, 1) is given (B = 1)."""
    b, c, t, n = v.shape
    zone = zones(v)
    out = v.new_zeros(out_shape)
    for i, cell in enumerate(cells):
        sel = (zone == i) & valid
        order, inverse = compaction(sel)
        sel_sorted = torch.gather(sel, 1, order)
        v_i = torch.gather(v, 3, order[:, None, None, :].expand(b, c, t, n))
        extra = {} if noise is None else {"noise": noise, "noise_scale": NOISE_WEIGHT[i]}
        out_i = cell(zero_invalid(v_i, sel_sorted, 3), sel_sorted, **extra)
        out_i = torch.gather(out_i, 3, inverse[:, None, None, :].expand(out_shape))
        out = torch.where(sel[:, None, None, :], out_i, out)
    return out


class SocialImplicitLight(nn.Module):
    """SocialImplicitLight with a per-scene zone compaction."""

    def __init__(self, spatial_input: int = 1, spatial_output: int = 20,
                 temporal_input: int = 8, temporal_output: int = 6):
        super().__init__()
        self.out_shape = (spatial_output, temporal_output)
        for i in range(len(BINS)):
            self.add_module(f"cell_{i}", SocialCellGlobal(
                spatial_input, spatial_output, temporal_input, temporal_output))

    def forward(self, v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        # v (B, 1, T, V) -> (B, s, T_out, V)
        cells = [getattr(self, f"cell_{i}") for i in range(len(BINS))]
        return route_by_zone(cells, v, valid, (v.shape[0], *self.out_shape, v.shape[3]))


class SocialImplicit(nn.Module):
    """The full SocialImplicit over one scene, as the JAX module takes it:
    v (1, C, T, V), valid (V,) -> (KSTEPS, C_out, T_out, V). The (KSTEPS, C)
    standard-normal draw `noise` is injected, or drawn from `generator` (on
    the input's device) where it is None. Dormant: nothing in the ET
    pipeline calls it."""

    def __init__(self, spatial_input: int = 2, spatial_output: int = 2,
                 temporal_input: int = 8, temporal_output: int = 12):
        super().__init__()
        self.spatial_input = spatial_input
        self.out_shape = (spatial_output, temporal_output)
        for i in range(len(BINS)):
            self.add_module(f"cell_{i}", SocialCellGlobal(
                spatial_input, spatial_output, temporal_input, temporal_output))

    def forward(self, v: torch.Tensor, valid: torch.Tensor, ksteps: int = 20,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if noise is None:
            noise = torch.randn((ksteps, self.spatial_input), generator=generator,
                                device=v.device, dtype=v.dtype)
        noise = noise[:, :, None, None].to(v.dtype)
        cells = [getattr(self, f"cell_{i}") for i in range(len(BINS))]
        return route_by_zone(cells, v, valid[None], (noise.shape[0], *self.out_shape, v.shape[3]),
                             noise=noise)


def make_model(cfg) -> SocialImplicitLight:
    return SocialImplicitLight(spatial_input=1, spatial_output=cfg.num_samples,
                               temporal_input=cfg.k + 2, temporal_output=cfg.k)


def prepare(c_obs: torch.Tensor, obs_ori: torch.Tensor, aux: Dict) -> Tuple:
    """Pre-hook: c_obs (B, k, V), obs_ori (B, 2, V) -> (v (B, 1, k+2, V)
    detached, valid)."""
    valid = aux["ped_valid"]
    obs = torch.cat([c_obs, obs_ori], dim=1)
    return (zero_invalid(obs, valid, axis=2).detach()[:, None], valid)


def finalize(output_data: torch.Tensor, aux: Dict) -> torch.Tensor:
    """Post-hook: (B, s, k, V) -> (B, k, V, s)."""
    return output_data.permute(0, 2, 3, 1)


BATCHING = "sequenced"
