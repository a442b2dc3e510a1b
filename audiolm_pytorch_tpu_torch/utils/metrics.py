"""Audio quality metrics, held against the JAX package's `utils/metrics.py`:
SI-SNR only."""
from __future__ import annotations

import torch

__all__ = ["si_snr"]


def si_snr(est, ref, eps: float = 1e-8):
    """Scale-invariant SNR in dB of est against ref, both (..., T). Higher
    is better."""
    est = est - est.mean(-1, keepdim=True)
    ref = ref - ref.mean(-1, keepdim=True)
    proj = ((est * ref).sum(-1, keepdim=True) / ((ref * ref).sum(-1, keepdim=True) + eps)) * ref
    noise = est - proj
    ratio = ((proj * proj).sum(-1) + eps) / ((noise * noise).sum(-1) + eps)
    return 10.0 * torch.log10(ratio)
