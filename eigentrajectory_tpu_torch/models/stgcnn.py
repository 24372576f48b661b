"""ET-STGCNN: Social-STGCNN predictor in ET coefficient space.

The counterpart of `eigentrajectory_tpu/models/stgcnn.py`, with the wiring
n_stgcnn=1, n_txpcnn=5, input_feat=1, output_feat=s, seq_len=k+2,
pred_seq_len=k. The scene axis is the conv batch axis: v (B, 1, T, V) and
one adjacency (T, V, V) per scene.

Quirks reproduced deliberately:
  * the channel/time "view" between the GCN and TXP-CNN stages is a raw
    reinterpretation of memory, not a transpose: `reshape` of a contiguous
    (B, C, T, V) tensor keeps each scene's block where the JAX package's
    per-scene reshape puts it;
  * tpcnn_4 / prelu_4 are built but never called, so parameter names map
    one to one;
  * the TXP-CNN 3x3 convs convolve over (channel, ped) as spatial dims, so
    padded ped slots are re-zeroed before every op that mixes peds.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .common import MaskedBatchNorm2d, PReLU, TorchConv2d, zero_invalid


def generate_adjacency_matrix(v: torch.Tensor, valid: torch.Tensor,
                              pair_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-distance normalized-Laplacian adjacency.

    v: (B, 1, T, V) coefficient sequences; valid: (B, V) bool; pair_mask:
    optional (B, V, V) bool multiplying the inverse-distance kernel (the
    GP-Graph intra-group stream's group mask).
    Returns (B, T, V, V). Padded nodes are isolated (their rows/cols vanish).
    """
    x = v[:, 0]                                              # (B, T, V)
    a = torch.abs(x[..., :, None] - x[..., None, :])         # (B, T, V, V)
    zero = a == 0
    a_inv = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, a))
    mask = valid[:, :, None] & valid[:, None, :]
    if pair_mask is not None:
        mask = mask & pair_mask
    mask = mask.to(x.dtype)
    a_inv = a_inv * mask[:, None]
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    a_hat = a_inv + eye
    deg = a_hat.sum(dim=-1)                                  # (B, T, V)
    dinv = torch.where(deg > 0, deg ** -0.5, 0.0)
    # D^-1/2 A D^-1/2 with diagonal D, as a broadcast product.
    return eye - dinv[..., :, None] * a_hat * dinv[..., None, :]


class STGCN(nn.Module):
    """st_gcn block: graph conv + temporal conv + residual, PReLU output.

    `single_relation` is the GP-Graph variant: the graph conv emits
    out_channels (not out_channels * K) and contracts 'nctv,tvw->nctw'."""

    def __init__(self, in_channels: int, out_channels: int, t_kernel: int,
                 spatial_kernel: int, single_relation: bool = False):
        super().__init__()
        self.spatial_kernel = spatial_kernel
        self.single_relation = single_relation
        self.res_conv = TorchConv2d(in_channels, out_channels, (1, 1))
        self.res_bn = MaskedBatchNorm2d(out_channels)
        self.gcn_conv = TorchConv2d(
            in_channels, out_channels * (1 if single_relation else spatial_kernel), (1, 1))
        self.tcn_bn1 = MaskedBatchNorm2d(out_channels)
        self.tcn_prelu = PReLU()
        pad = (t_kernel - 1) // 2
        self.tcn_conv = TorchConv2d(out_channels, out_channels, (t_kernel, 1),
                                    padding=(pad, 0))
        self.tcn_bn2 = MaskedBatchNorm2d(out_channels)
        self.out_prelu = PReLU()

    def forward(self, x: torch.Tensor, a: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        # x: (B, C_in, T, V); a: (B, K=T, V, V). In != out in the ET wiring.
        res = self.res_bn(self.res_conv(x), valid)
        h = self.gcn_conv(x)
        if self.single_relation:
            h = torch.einsum("bctv,btvw->bctw", h, a)
        else:
            b, kc, t, v = h.shape
            h = h.reshape(b, self.spatial_kernel, kc // self.spatial_kernel, t, v)
            h = torch.einsum("bkctv,bkvw->bctw", h, a)
        h = self.tcn_prelu(self.tcn_bn1(h, valid))
        h = self.tcn_bn2(self.tcn_conv(h), valid)
        return self.out_prelu(h + res)


class SocialSTGCNN(nn.Module):
    """social_stgcnn with the ET wiring."""

    def __init__(self, n_stgcnn: int = 1, n_txpcnn: int = 5, input_feat: int = 1,
                 output_feat: int = 20, seq_len: int = 8, pred_seq_len: int = 6,
                 kernel_size: int = 3, single_relation: bool = False):
        super().__init__()
        self.n_stgcnn = n_stgcnn
        self.n_txpcnn = n_txpcnn
        for i in range(n_stgcnn):
            cin = input_feat if i == 0 else output_feat
            self.add_module(f"st_gcn_{i}", STGCN(cin, output_feat, kernel_size, seq_len,
                                                 single_relation=single_relation))
        self.tpcnn_0 = TorchConv2d(seq_len, pred_seq_len, (3, 3), padding=(1, 1))
        self.prelu_0 = PReLU()
        # tpcnn_{n_txpcnn-1} is built and never called, as in the reference.
        for k in range(1, n_txpcnn):
            self.add_module(f"tpcnn_{k}", TorchConv2d(
                pred_seq_len, pred_seq_len, (3, 3), padding=(1, 1)))
            self.add_module(f"prelu_{k}", PReLU())
        self.tpcnn_output = TorchConv2d(pred_seq_len, pred_seq_len, (3, 3),
                                        padding=(1, 1))

    def unused_prefixes(self) -> Tuple[str, ...]:
        """Names of the layers that are built and never called (a checkpoint
        of the JAX package holds no weights for them)."""
        last = self.n_txpcnn - 1
        return (f"tpcnn_{last}.", f"prelu_{last}.")

    def forward(self, v: torch.Tensor, a: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        # v: (B, input_feat, T, V) -> (B, output_feat, pred_seq_len, V)
        for i in range(self.n_stgcnn):
            v = getattr(self, f"st_gcn_{i}")(v, a, valid)

        # raw memory reinterpretation, NOT a transpose
        v = v.reshape(v.shape[0], v.shape[2], v.shape[1], v.shape[3])

        v = zero_invalid(v, valid, axis=3)
        v = self.prelu_0(self.tpcnn_0(v))
        v = zero_invalid(v, valid, axis=3)
        for k in range(1, self.n_txpcnn - 1):
            v = getattr(self, f"prelu_{k}")(getattr(self, f"tpcnn_{k}")(v)) + v
            v = zero_invalid(v, valid, axis=3)

        v = self.tpcnn_output(v)
        v = zero_invalid(v, valid, axis=3)

        # reinterpretation back
        return v.reshape(v.shape[0], v.shape[2], v.shape[1], v.shape[3])


def make_model(cfg) -> nn.Module:
    return SocialSTGCNN(
        n_stgcnn=1, n_txpcnn=5, input_feat=1, output_feat=cfg.num_samples,
        seq_len=cfg.k + 2, pred_seq_len=cfg.k, kernel_size=3)


def prepare(c_obs: torch.Tensor, obs_ori: torch.Tensor, aux: Dict) -> Tuple:
    """Pre-hook: concat origin rows, build the graph.

    c_obs (B, k, V), obs_ori (B, 2, V) -> (v (B, 1, k+2, V), a, valid).
    """
    valid = aux["ped_valid"]
    obs = torch.cat([c_obs, obs_ori], dim=1)                 # (B, k+2, V)
    obs = zero_invalid(obs, valid, axis=2).detach()
    v = obs[:, None]                                         # (B, 1, T, V)
    a = generate_adjacency_matrix(v, valid)
    return (v, a, valid)


def finalize(output_data: torch.Tensor, aux: Dict) -> torch.Tensor:
    """Post-hook: (B, s, k, V) -> (B, k, V, s)."""
    return output_data.permute(0, 2, 3, 1)


BATCHING = "sequenced"
