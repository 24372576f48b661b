"""ET-Graph-TERN: multi-relational GCN + endpoint-CNN predictor in ET space.

The counterpart of the live `GraphTERNLight` path of
`eigentrajectory_tpu/models/graphtern.py`, with the wiring n_epgcn=1,
n_epcnn=6, input_feat=1, seq k+2 -> k, n_smpl=s. A four-relation adjacency
[dist, disp, 1/dist, 1/disp], one st_mrgcn over a normalized
adjacency-tilde with DropEdge (p = 0.8) in training, and six epcnn blocks.
The scene axis is written out: s_obs (B, 2, T, N, 1) [abs, rel] and a (B, N)
validity mask.

The full graph_tern (`GraphTERNFull`: a GMM control-point head, endpoint
sampling with pruning, linear interpolation and the `TRCNN` refinement over
the sample batch) never runs in the ET pipeline; it is the counterpart of the
JAX package's dormant module, held against it by tests/test_torch_dormant.py.
Its random draws come from an explicit `torch.Generator`.

The epcnn convs pad their (channel, ped) planes by REPLICATION. Under ped
padding the replicated edge must be the last valid ped of each scene, so the
trailing invalid slots of every row take the values of its last valid slot
before each such conv (`clamp_to_valid`; valid slots are front-contiguous).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


class TRCNN(nn.Module):
    """trcnn, the refinement twin of EPCNN: a time-wise replicate conv (3)
    and a channel-wise one (t_ksize), plus the residual: the identity where
    total == pred, else `resconv`, a (total - pred + 1, 1) conv over time."""

    def __init__(self, total_seq_len: int, pred_seq_len: int, in_channels: int,
                 out_channels: int, t_ksize: int = 3):
        super().__init__()
        self.same_t = total_seq_len == pred_seq_len
        if not self.same_t:
            self.resconv = TorchConv2d(in_channels, out_channels,
                                       (total_seq_len - pred_seq_len + 1, 1))
        self.tpcn = ReplicateConv2d(total_seq_len, pred_seq_len, 3)
        self.tpcn_prelu = PReLU()
        self.cpcn = ReplicateConv2d(in_channels, out_channels, t_ksize)
        self.cpcn_prelu = PReLU()

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        # x (B, T, C, V)
        res = x if self.same_t else self.resconv(x.transpose(1, 2)).transpose(1, 2)
        h = self.tpcn_prelu(self.tpcn(clamp_to_valid(x, valid, 3)))
        h = h.transpose(1, 2)                                   # NTCV -> NCTV
        h = self.cpcn_prelu(self.cpcn(clamp_to_valid(h, valid, 3)))
        return h.transpose(1, 2) + res


def gmm_endpoint_sample(v_init: torch.Tensor, n_smpl: int, n_ways: int,
                        prune: Optional[int] = None,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Endpoints from the n_ways GMM heads: v_init (1, M, V, 5 * n_ways) of
    per-component [mu_x, mu_y, log_std_x, log_std_y, pi_logit] -> (n_smpl,
    V, 2), the mean over the ways of one mixture draw each (component from
    softmax(pi), then mu + std * N(0, I)), detached. `prune` sets that many
    lowest-pi components (ranked by a double stable argsort) to -1e8 first.
    The draws come from `generator`, on v_init's device."""
    dests = []
    for chunk in torch.chunk(v_init, n_ways, dim=-1):
        t = chunk.transpose(1, 2)[0]                            # (V, M, 5)
        logits = t[..., 4]                                      # (V, M)
        if prune is not None:
            ranks = torch.argsort(torch.argsort(logits, dim=-1, stable=True), dim=-1,
                                  stable=True)
            logits = torch.where(ranks < prune, -1e8, logits)
        v = t.shape[0]
        comp = torch.multinomial(torch.softmax(logits, dim=-1), n_smpl, replacement=True,
                                 generator=generator).T         # (S, V)
        mu, std = t[..., :2], torch.exp(t[..., 2:4])
        eps = torch.randn((n_smpl, v, 2), generator=generator, device=t.device, dtype=t.dtype)
        vi = torch.arange(v, device=t.device)[None, :]
        dests.append((mu[vi, comp] + std[vi, comp] * eps).detach())
    return torch.stack(dests, dim=3).mean(dim=3)


def prune_select(endpoint_sets: torch.Tensor) -> torch.Tensor:
    """Per pedestrian, the sampling round whose samples are most spread:
    the largest sum over samples of the distance to the nearest other sample
    (the second smallest of each row of the pairwise distances); ties go to
    the first round. endpoint_sets (R, S, V, 2) -> (S, V, 2)."""
    diff = endpoint_sets[:, None] - endpoint_sets[:, :, None]
    d = torch.sqrt((diff * diff).sum(dim=-1))                   # (R, S, S, V)
    nearest = torch.sort(d, dim=2).values[:, :, 1]              # (R, S, V)
    r = torch.argmax(nearest.sum(dim=1), dim=0)                 # (V,)
    v = torch.arange(endpoint_sets.shape[2], device=endpoint_sets.device)
    return endpoint_sets[r, :, v].transpose(0, 1)


def guided_endpoint_sample(v_dest_rel: torch.Tensor, gamma: torch.Tensor, n_smpl: int,
                           eps_r: Optional[torch.Tensor] = None,
                           eps_t: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The training phase's guided samples: v_dest_rel (V, 2) plus polar
    perturbations of radius U[0, gamma_v] and angle U[0, 1] *radians* (the
    reference's quirk, kept) -> (n_smpl, V, 2). Where `eps_r` is None, both
    draws come from `generator`."""
    if eps_r is None:
        v = v_dest_rel.shape[0]
        like = dict(generator=generator, device=v_dest_rel.device, dtype=v_dest_rel.dtype)
        eps_r = torch.rand((n_smpl, v), **like) * gamma[None, :]
        eps_t = torch.rand((n_smpl, v), **like)
    return v_dest_rel[None] + torch.stack([eps_r * torch.cos(eps_t), eps_r * torch.sin(eps_t)],
                                          dim=-1)


class GraphTERNFull(nn.Module):
    """The full graph_tern over one scene, as the JAX module takes it:
    s_obs (1, 2, T_obs, V, 2) [abs, rel], valid (V,). The control-point GCN
    runs on the relative stream and ends in a GMM head v_init (1, n_gmms, V,
    5 * n_ways); endpoints are injected (`endpoint_set` (S, V, 2)) or drawn
    from it (`pruning`: n_smpl rounds with that many components pruned, the
    most spread round kept); the linear interpolation to each endpoint is
    refined by an st_mrgcn and `n_trcnn` TRCNNs over the sample batch.
    Returns (v_init, v_pred, v_refi). Dormant: nothing in the ET pipeline
    calls it."""

    def __init__(self, n_epgcn: int = 1, n_epcnn: int = 6, n_trgcn: int = 1, n_trcnn: int = 4,
                 seq_len: int = 8, pred_seq_len: int = 12, n_ways: int = 3, n_smpl: int = 20,
                 hidden_feat: int = 16, n_gmms: int = 8, input_feat: int = 2,
                 output_feat: int = 5):
        super().__init__()
        self.n_epgcn, self.n_epcnn, self.n_trgcn, self.n_trcnn = n_epgcn, n_epcnn, n_trgcn, n_trcnn
        self.pred_seq_len, self.n_ways, self.n_smpl = pred_seq_len, n_ways, n_smpl
        total = seq_len + pred_seq_len
        for k in range(n_epgcn):
            self.add_module(f"tp_mrgcn_{k}", STMRGCN(
                input_feat if k == 0 else hidden_feat, hidden_feat, seq_len))
        seqs = [seq_len] + [n_gmms] * (n_epcnn - 1)
        chans = [hidden_feat] * (n_epcnn - 1) + [output_feat * n_ways]
        for k in range(n_epcnn):
            self.add_module(f"epcnn_{k}", EPCNN(seqs[k], n_gmms, hidden_feat, chans[k]))
        for k in range(n_trgcn):
            self.add_module(f"st_mrgcn_{k}", STMRGCN(
                input_feat if k == 0 else hidden_feat, hidden_feat, total))
        for j in range(n_trcnn - 1):
            self.add_module(f"trcnn_{j}", TRCNN(total, total, hidden_feat, hidden_feat,
                                                t_ksize=(n_trcnn - j) * 2 + 1))
        self.add_module(f"trcnn_{n_trcnn - 1}", TRCNN(total, pred_seq_len, hidden_feat,
                                                      input_feat, t_ksize=3))

    def forward(self, s_obs: torch.Tensor, valid: torch.Tensor,
                endpoint_set: Optional[torch.Tensor] = None, pruning: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        row = valid[None]                                       # (1, V)
        with torch.no_grad():
            a_obs = generate_adjacency(s_obs, row)
        v_obs_abs, v_obs_rel = s_obs[:, 0], s_obs[:, 1]

        # Control points: the GMM head, from the relative stream.
        h = v_obs_rel.permute(0, 3, 1, 2)                       # NTVC -> NCTV
        for k in range(self.n_epgcn):
            h = getattr(self, f"tp_mrgcn_{k}")(h, a_obs)
        h = zero_invalid(h.transpose(1, 2), row, 3)             # NCTV -> NTCV
        for k in range(self.n_epcnn):
            h = zero_invalid(getattr(self, f"epcnn_{k}")(h, row), row, 3)
        v_init = h.transpose(2, 3)                              # (1, M, V, 5 * n_ways)

        if endpoint_set is None:
            if pruning is None:
                endpoint_set = gmm_endpoint_sample(v_init, self.n_smpl, self.n_ways,
                                                   generator=generator)
            else:
                endpoint_set = prune_select(torch.stack([
                    gmm_endpoint_sample(v_init, self.n_smpl, self.n_ways, prune=pruning,
                                        generator=generator)
                    for _ in range(self.n_smpl)]))

        # Linear interpolation to the endpoints, refined over the sample batch.
        s = endpoint_set.shape[0]
        v_pred = endpoint_set[:, None].expand(-1, self.pred_seq_len, -1, -1)  # (S, P, V, 2)
        with torch.no_grad():
            v_pred_abs = torch.cumsum(v_pred, dim=1) + v_obs_abs[0, -1]
            rows = row.expand(s, -1)
            a_pred = generate_adjacency(torch.stack([v_pred_abs, v_pred], dim=1), rows)
            v_full = torch.cat([v_obs_rel.expand(s, -1, -1, -1), v_pred], dim=1)
            a_full = torch.cat([a_obs.expand(s, -1, -1, -1, -1), a_pred], dim=2)
        h = v_full.permute(0, 3, 1, 2)                          # NTVC -> NCTV
        for k in range(self.n_trgcn):
            h = getattr(self, f"st_mrgcn_{k}")(h, a_full)
        h = h.transpose(1, 2)                                   # NCTV -> NTCV
        for j in range(self.n_trcnn):
            h = getattr(self, f"trcnn_{j}")(h, rows)
        v_corr = h.transpose(2, 3)                              # (S, P, V, input_feat)
        v_refi = torch.cat([v_pred_abs[:, :-1] + v_corr[:, :-1], v_pred_abs[:, -1:]], dim=1)
        return v_init, v_pred, v_refi


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
