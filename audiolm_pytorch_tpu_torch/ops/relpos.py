"""Relative-position bias expansion, held against the JAX package's
`ops/relpos.py::toeplitz_expand`.

The continuous rel-pos bias is a (2j-1, H) table over signed distances;
attention over i query rows (the last i of j positions) and j keys needs
bias[h, q, k] = tab[(q + j - i) - k + j - 1, h]. The flash kernel reads the
table directly; this materialisation serves the plain paths.
"""
from __future__ import annotations

import torch

__all__ = ["toeplitz_expand", "table_rows"]


def table_rows(tab, q_pos, j: int):
    """(H, len(q_pos), j) bias rows for query positions `q_pos` over keys 0..j-1."""
    k_pos = torch.arange(j, device=tab.device)
    return tab[q_pos[:, None] - k_pos[None, :] + (j - 1)].permute(2, 0, 1)


def toeplitz_expand(tab, i: int, j: int):
    """(2j-1, H) table -> (H, i, j) bias for the last i of j positions."""
    return table_rows(tab, torch.arange(j - i, j, device=tab.device), j)
