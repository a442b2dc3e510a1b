"""Residual vector quantization of the codec at serving time, held against
the JAX package's `ops/quantize.py` (`VectorQuantizeEMA`, `ResidualVQ`,
`GroupedResidualVQ`) in eval mode.

The nearest-code search is K6 (`ops/kernels/vq.py`). The codebooks and the
EMA statistics are buffers, so a JAX checkpoint loads whole; the EMA update,
kmeans init, dead-code expiry, quantizer dropout and stochastic code
sampling are training and are not ported: `train=True` raises.
"""
from __future__ import annotations

import torch
from torch import nn

from .kernels.vq import vq_nearest_code

__all__ = ["VectorQuantizeEMA", "ResidualVQ", "GroupedResidualVQ"]


def _refuse_training(train: bool):
    if train:
        raise NotImplementedError("training the quantizer (EMA update, kmeans init, "
                                  "dead-code expiry, quantizer dropout) is not ported")


def _l2norm(t, eps: float = 1e-12):
    return t / t.norm(dim=-1, keepdim=True).clamp(min=eps)


def _rotate_to(x, q):
    """The rotation-trick straight-through of the JAX package, as written
    there: the gradient reaches x through a detached rotation and rescale;
    the value is (q - st) + st, within rounding of q but not bit-equal to it,
    and the next quantizer's residual is taken from this value."""
    eps = 1e-6
    nx = x.norm(dim=-1, keepdim=True)
    nq = q.norm(dim=-1, keepdim=True)
    u = (x / nx.clamp(min=eps)).detach()
    qh = (q / nq.clamp(min=eps)).detach()
    w = _l2norm(u + qh).detach()
    rotated = x - 2.0 * (x * w).sum(-1, keepdim=True) * w \
        + 2.0 * (x * u).sum(-1, keepdim=True) * qh
    scale = (nq / nx.clamp(min=eps)).clamp(0.25, 4.0).detach()
    st = rotated * scale
    return (q - st).detach() + st


class VectorQuantizeEMA(nn.Module):
    """One codebook (C, D). The codebook starts at zeros, as the JAX
    package's does under kmeans init (its values come from a checkpoint)."""

    def __init__(self, dim: int, codebook_size: int, *, commitment_weight: float = 1.0,
                 rotation_trick: bool = True):
        super().__init__()
        self.register_buffer("codebook", torch.zeros(codebook_size, dim))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim))
        self.register_buffer("initted", torch.tensor(False))
        self.dim = dim
        self.codebook_size = codebook_size
        self.commitment_weight = commitment_weight
        self.rotation_trick = rotation_trick

    def encode(self, x):
        """x (..., D) -> int64 indices (...): K6 on a CUDA tensor."""
        flat = x.detach().reshape(-1, self.dim)
        return vq_nearest_code(flat, self.codebook).long().reshape(x.shape[:-1])

    def decode(self, indices):
        return self.codebook[indices]

    def forward(self, x, *, train: bool = False):
        """(quantized, indices, commitment loss) of x (..., D)."""
        _refuse_training(train)
        idx = self.encode(x)
        quantized = self.decode(idx).to(x.dtype)
        commit = self.commitment_weight * (quantized.float() - x.float()).square().mean()
        if self.rotation_trick:
            out = _rotate_to(x.reshape(-1, self.dim), quantized.reshape(-1, self.dim))
            out = out.reshape(x.shape).to(x.dtype)
        else:
            out = x + (quantized - x).detach()
        return out, idx, commit


class ResidualVQ(nn.Module):
    """`num_quantizers` codebooks, each quantizing what the ones before it
    left."""

    def __init__(self, *, dim: int, num_quantizers: int, codebook_size: int,
                 commitment_weight: float = 1.0, rotation_trick: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            VectorQuantizeEMA(dim, codebook_size, commitment_weight=commitment_weight,
                              rotation_trick=rotation_trick)
            for _ in range(num_quantizers))
        self.dim = dim
        self.num_quantizers = num_quantizers
        self.codebook_size = codebook_size

    @property
    def codebooks(self):
        return torch.stack([layer.codebook for layer in self.layers])  # (Q, C, D)

    def forward(self, x, *, train: bool = False):
        """x (B, N, D) -> (quantized, indices (B, N, Q) int64, commitment
        losses (Q,))."""
        _refuse_training(train)
        residual = x
        quantized_out = torch.zeros_like(x)
        all_idx, all_loss = [], []
        for layer in self.layers:
            quantized, idx, loss = layer(residual)
            residual = residual - quantized.detach()
            quantized_out = quantized_out + quantized
            all_idx.append(idx)
            all_loss.append(loss)
        return quantized_out, torch.stack(all_idx, -1), torch.stack(all_loss)

    def get_output_from_indices(self, indices):
        """indices (B, N, Q') with -1 for dropped or padded codes, Q' <= Q
        (coarse codes only, say) -> (B, N, D), summed in quantizer order."""
        out = torch.zeros(*indices.shape[:-1], self.dim, device=indices.device,
                          dtype=self.layers[0].codebook.dtype)
        for qi in range(min(self.num_quantizers, indices.shape[-1])):
            idx = indices[..., qi]
            emb = self.layers[qi].codebook[idx.clamp(min=0)]
            out = out + torch.where((idx >= 0)[..., None], emb, 0.0)
        return out


class GroupedResidualVQ(nn.Module):
    """The feature dim split into `groups`, one ResidualVQ each."""

    def __init__(self, *, dim: int, groups: int = 1, **kwargs):
        super().__init__()
        if dim % groups:
            raise ValueError(f"dim {dim} is not a multiple of groups {groups}")
        self.rvqs = nn.ModuleList(ResidualVQ(dim=dim // groups, **kwargs) for _ in range(groups))
        self.dim = dim
        self.groups = groups

    @property
    def num_quantizers(self):
        return self.rvqs[0].num_quantizers

    @property
    def codebook_size(self):
        return self.rvqs[0].codebook_size

    def forward(self, x, *, train: bool = False):
        """x (B, N, D) -> (quantized, indices (G, B, N, Q), losses (G, Q))."""
        _refuse_training(train)
        outs, idxs, losses = zip(*(rvq(chunk) for rvq, chunk in
                                   zip(self.rvqs, x.chunk(self.groups, dim=-1))))
        return torch.cat(outs, -1), torch.stack(idxs), torch.stack(losses)

    def get_output_from_indices(self, indices):
        """indices (G, B, N, Q') -> (B, N, D)."""
        return torch.cat([rvq.get_output_from_indices(indices[g])
                          for g, rvq in enumerate(self.rvqs)], dim=-1)
