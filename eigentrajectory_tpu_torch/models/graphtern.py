"""ET-Graph-TERN: multi-relational GCN + endpoint-CNN predictor in ET space.

The counterpart of the live `GraphTERNLight` path of
`eigentrajectory_tpu/models/graphtern.py`, with the wiring n_epgcn=1,
n_epcnn=6, input_feat=1, seq k+2 -> k, n_smpl=s. A four-relation adjacency
[dist, disp, 1/dist, 1/disp], one st_mrgcn over a normalized
adjacency-tilde with DropEdge (p = 0.8) in training, and six epcnn blocks.
The scene axis is written out: s_obs (B, 2, T, N, 1) [abs, rel] and a (B, N)
validity mask. The dormant full model (GMM endpoints, refinement) is not
ported.

The epcnn convs pad their (channel, ped) planes by REPLICATION. Under ped
padding the replicated edge must be the last valid ped of each scene, so the
trailing invalid slots of every row take the values of its last valid slot
before each such conv (`clamp_to_valid`; valid slots are front-contiguous).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import PReLU, TorchConv2d, zero_invalid
from .dmrgcn import MultiRelationalGCN, degree_rsqrt


def normalized_adjacency_tilde(a: torch.Tensor) -> torch.Tensor:
    """A~norm = D~^-1/2 (A + I) D~^-1/2 over the leading axes."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    a_t = a + eye
    dinv = degree_rsqrt(a_t.sum(dim=-1))
    return dinv[..., :, None] * a_t * dinv[..., None, :]


def clamp_to_valid(x: torch.Tensor, valid: torch.Tensor, axis: int) -> torch.Tensor:
    """Each row's slots past its last valid one take that slot's values: x
    (B, ...) with the ped axis at `axis`, valid (B, N) front-contiguous. The
    count is per row (per scene), at least 1."""
    n = x.shape[axis]
    nv = torch.clamp_min(valid.sum(dim=1), 1)                        # (B,)
    idx = torch.minimum(torch.arange(n, device=x.device)[None, :], nv[:, None] - 1)
    shape = [1] * x.ndim
    shape[0], shape[axis] = x.shape[0], n
    return torch.gather(x, axis, idx.reshape(shape).expand(x.shape))


class ReplicateConv2d(nn.Module):
    """Conv2d over NCHW with padding_mode='replicate': an edge pad of k // 2
    on both spatial axes, then the VALID conv `conv`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.pad = kernel_size // 2
        self.conv = TorchConv2d(in_channels, out_channels, (kernel_size, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pad
        return self.conv(F.pad(x, (p, p, p, p), mode="replicate"))


class STMRGCN(nn.Module):
    """st_mrgcn with use_mdn=True: the 4-relation GCN, PReLU, a (t_kernel, 1)
    temporal conv and the residual; no output PReLU."""

    def __init__(self, in_channels: int, out_channels: int, seq_len: int, t_kernel: int = 3):
        super().__init__()
        self.same = in_channels == out_channels
        if not self.same:
            self.res_conv = TorchConv2d(in_channels, out_channels, (1, 1))
        self.gcn = MultiRelationalGCN(in_channels, out_channels, 4, seq_len,
                                      normalize=normalized_adjacency_tilde)
        self.tcn_prelu = PReLU()
        pad = (t_kernel - 1) // 2
        self.tcn_conv = TorchConv2d(out_channels, out_channels, (t_kernel, 1),
                                    padding=(pad, 0))

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        res = x if self.same else self.res_conv(x)
        return self.tcn_conv(self.tcn_prelu(self.gcn(x, a))) + res


class EPCNN(nn.Module):
    """epcnn: a time-wise replicate conv over (C, V) planes of (B, T, C, V),
    then a channel-wise one over (T, V) planes of (B, C, T, V), plus the
    residual: the identity, `restconv` (1x1 over time), `rescconv` (1x1 over
    channels) or both in that order, as the shapes differ."""

    def __init__(self, obs_seq_len: int, pred_seq_len: int, in_channels: int,
                 out_channels: int):
        super().__init__()
        self.same_t = obs_seq_len == pred_seq_len
        self.same_c = in_channels == out_channels
        if not self.same_t:
            self.restconv = TorchConv2d(obs_seq_len, pred_seq_len, (1, 1))
        if not self.same_c:
            self.rescconv = TorchConv2d(in_channels, out_channels, (1, 1))
        self.tpcn = ReplicateConv2d(obs_seq_len, pred_seq_len, 3)
        self.tpcn_prelu = PReLU()
        self.cpcn = ReplicateConv2d(in_channels, out_channels, 3)
        self.cpcn_prelu = PReLU()

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        # x (B, T, C, V)
        res = x if self.same_t else self.restconv(x)
        if not self.same_c:
            res = self.rescconv(res.transpose(1, 2)).transpose(1, 2)
        h = self.tpcn_prelu(self.tpcn(clamp_to_valid(x, valid, 3)))
        h = h.transpose(1, 2)                                   # NTCV -> NCTV
        h = self.cpcn_prelu(self.cpcn(clamp_to_valid(h, valid, 3)))
        return h.transpose(1, 2) + res


class GraphTERNLight(nn.Module):
    """graph_tern_light with the ET wiring."""

    def __init__(self, n_epgcn: int = 1, n_epcnn: int = 6, input_feat: int = 1,
                 seq_len: int = 8, pred_seq_len: int = 6, n_smpl: int = 20,
                 hidden_feat: int = 16):
        super().__init__()
        self.n_epgcn, self.n_epcnn = n_epgcn, n_epcnn
        for k in range(n_epgcn):
            self.add_module(f"tp_mrgcn_{k}", STMRGCN(
                input_feat if k == 0 else hidden_feat, hidden_feat, seq_len))
        seqs = [seq_len] + [pred_seq_len] * (n_epcnn - 1)
        chans = [hidden_feat] * (n_epcnn - 1) + [n_smpl]
        for k in range(n_epcnn):
            self.add_module(f"epcnn_{k}", EPCNN(seqs[k], pred_seq_len, hidden_feat, chans[k]))

    def forward(self, s_obs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        # s_obs (B, 2, T, N, 1) [abs, rel] -> (B, pred_seq_len, N, n_smpl)
        v = s_obs[:, 0].permute(0, 3, 1, 2)                      # NTVC -> NCTV
        with torch.no_grad():
            a = generate_adjacency(s_obs, valid)
        for k in range(self.n_epgcn):
            v = getattr(self, f"tp_mrgcn_{k}")(v, a)
        v = zero_invalid(v.transpose(1, 2), valid, 3)            # NCTV -> NTCV
        for k in range(self.n_epcnn):
            v = zero_invalid(getattr(self, f"epcnn_{k}")(v, valid), valid, 3)
        return v.transpose(2, 3)                                 # NTCV -> NTVC


def generate_adjacency(s_obs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[dist, disp, 1/dist, 1/disp] (1/0 -> 0), zeroed where either slot is
    padding: s_obs (B, 2, T, N, C) -> (B, 4, T, N, N)."""
    diff = s_obs[:, :, :, :, None, :] - s_obs[:, :, :, None, :, :]
    a = torch.sqrt((diff * diff).sum(dim=-1))                    # (B, 2, T, N, N)
    a = a * (valid[:, :, None] & valid[:, None, :]).to(a.dtype)[:, None, None]
    zero = a == 0
    a_inv = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, a))
    return torch.cat([a, a_inv], dim=1)


def make_model(cfg) -> nn.Module:
    return GraphTERNLight(n_epgcn=1, n_epcnn=6, input_feat=1, seq_len=cfg.k + 2,
                          pred_seq_len=cfg.k, n_smpl=cfg.num_samples)


def prepare(c_obs: torch.Tensor, obs_ori: torch.Tensor, aux: Dict) -> Tuple:
    """Pre-hook: stack the coefficients [abs, frame-difference rel]:
    c_obs (B, k, N), obs_ori (B, 2, N) -> (s_obs (B, 2, k+2, N, 1), valid)."""
    valid = aux["ped_valid"]
    obs = zero_invalid(torch.cat([c_obs, obs_ori], dim=1), valid, axis=2).detach()
    s_abs = obs[..., None]                                       # (B, T, N, 1)
    s_rel = torch.cat([torch.zeros_like(s_abs[:, :1]), s_abs[:, 1:] - s_abs[:, :-1]], dim=1)
    return (torch.stack([s_abs, s_rel], dim=1), valid)


def finalize(output_data: torch.Tensor, aux: Dict) -> torch.Tensor:
    """Post-hook: (B, k, N, s), as it comes."""
    return output_data


BATCHING = "sequenced"
