"""Residual vector quantization of the codec, held against the JAX
package's `ops/quantize.py` (`VectorQuantizeEMA`, `ResidualVQ`,
`GroupedResidualVQ`), in eval and in training.

The nearest-code search is K6 (`ops/kernels/vq.py`) in both. The codebooks
and the EMA statistics are buffers, so a JAX checkpoint loads whole. In
training (`train=True`, with a `torch.Generator`) a quantizer initialises
its codebook by kmeans on the first batch, updates it by EMA from the codes
it picked (with dead-code expiry), and a residual quantizer drops the
quantizers past one random index a step. JAX returns the updated state;
here the buffers are updated in place, under no_grad, from the detached
input, after the codes are picked, so the step's outputs see the codebook
as it was. Dropped quantizers are not run: JAX runs them and throws away
their codes, loss and state, which gives the same outputs and gradients.

Every random draw (kmeans' candidates and starting permutation, dead-code
candidates, the dropout index, Gumbel noise) is made by one of the small
`draw_*` functions below from the caller's generator (on the CPU, so the
card and the CPU draw the same numbers from one seed).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .kernels.vq import vq_nearest_code

__all__ = ["VectorQuantizeEMA", "ResidualVQ", "GroupedResidualVQ", "draw_randint",
           "draw_permutation", "draw_dropout_index", "draw_uniform"]


def draw_randint(generator, high: int, num: int):
    """`num` ints uniform in [0, high), int64 on the CPU."""
    return torch.randint(high, (num,), generator=generator)


def draw_permutation(generator, n: int):
    """A random permutation of range(n), int64 on the CPU."""
    return torch.randperm(n, generator=generator)


def draw_dropout_index(generator, low: int, high: int) -> int:
    """One int uniform in [low, high)."""
    return int(torch.randint(low, high, (1,), generator=generator))


def draw_uniform(generator, shape):
    """float32 uniform in [1e-20, 1) on the CPU (Gumbel noise's input)."""
    return torch.rand(shape, generator=generator).clamp_(min=1e-20)


def _l2norm(t, eps: float = 1e-12):
    return t / t.norm(dim=-1, keepdim=True).clamp(min=eps)


def _sq_dist(x, e):
    """Squared euclidean distances (N, C) of x (N, D) to e (C, D), float32."""
    x, e = x.float(), e.float()
    return x.square().sum(-1, keepdim=True) - 2.0 * (x @ e.t()) + e.square().sum(-1)


def _sample_vectors(generator, x, num: int):
    """`num` rows of x (N, D) drawn with replacement."""
    return x[draw_randint(generator, x.shape[0], num).to(x.device)]


def _gather_candidates(generator, x, num: int):
    """`num` candidate rows of x: rows drawn from x, then drawn again from
    those (JAX's two draws, there so that data-parallel replicas share one
    pool; with one card the second draw is over one replica's rows)."""
    return _sample_vectors(generator, _sample_vectors(generator, x, num), num)


def _kmeans(generator, samples, num_clusters: int, iters: int = 10):
    """`iters` rounds of kmeans from a random subset of samples (N, D):
    (centers (C, D), the last round's counts (C,))."""
    perm = draw_permutation(generator, samples.shape[0]).to(samples.device)
    centers = samples[perm[:num_clusters]]
    counts = None
    for _ in range(iters):
        onehot = F.one_hot(_sq_dist(samples, centers).argmin(-1), num_clusters).float()
        counts = onehot.sum(0)
        sums = onehot.t() @ samples
        centers = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None], centers)
    return centers, counts


def _rotate_to(x, q):
    """The rotation-trick straight-through of the JAX package, as written
    there: the gradient reaches x through a detached rotation and rescale
    (the rescale clamped to [0.25, 4] on the gradient's path only); the
    value is (q - st) + st, within rounding of q but not bit-equal to it,
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
    """One codebook (C, D), learnt by EMA. Under kmeans init the codebook
    starts at zeros, uninitialised, until the first training batch (or a
    checkpoint) fills it; without, uniform in +-1 / C from `generator`."""

    def __init__(self, dim: int, codebook_size: int, *, decay: float = 0.95,
                 commitment_weight: float = 1.0, eps: float = 1e-5,
                 threshold_ema_dead_code: float = 2.0, kmeans_init: bool = True,
                 kmeans_iters: int = 10, rotation_trick: bool = True,
                 stochastic_sample_codes: bool = False, generator=None):
        super().__init__()
        if kmeans_init:
            codebook = torch.zeros(codebook_size, dim)
        else:
            codebook = (torch.rand(codebook_size, dim, generator=generator) * 2 - 1) \
                / codebook_size
        self.register_buffer("codebook", codebook)
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("embed_avg", codebook.clone())
        self.register_buffer("initted", torch.tensor(not kmeans_init))
        self.dim = dim
        self.codebook_size = codebook_size
        self.decay = decay
        self.commitment_weight = commitment_weight
        self.eps = eps
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.kmeans_iters = kmeans_iters
        self.rotation_trick = rotation_trick
        self.stochastic_sample_codes = stochastic_sample_codes

    def encode(self, x, *, generator=None):
        """x (..., D) -> int64 indices (...): K6 on a CUDA tensor; with
        stochastic codes and a generator, Gumbel-max over -distance."""
        flat = x.detach().reshape(-1, self.dim)
        if self.stochastic_sample_codes and generator is not None:
            dist = _sq_dist(flat, self.codebook)
            gumbel = -torch.log(-torch.log(draw_uniform(generator, dist.shape).to(dist.device)))
            idx = (gumbel - dist).argmax(-1)
        else:
            idx = vq_nearest_code(flat, self.codebook).long()
        return idx.reshape(x.shape[:-1])

    def decode(self, indices):
        return self.codebook[indices]

    @torch.no_grad()
    def _init_codebook(self, flat, generator):
        cand = _gather_candidates(generator, flat, max(4 * self.codebook_size, 1024))
        centers, counts = _kmeans(generator, cand, self.codebook_size, self.kmeans_iters)
        counts = counts.clamp(min=1.0)
        self.codebook.copy_(centers)
        self.embed_avg.copy_(centers * counts[:, None])
        self.cluster_size.copy_(counts)
        self.initted.fill_(True)

    @torch.no_grad()
    def _ema_update(self, flat, idx, generator):
        """The EMA of the codes' counts and sums (one-hot products, as in
        JAX, in a fixed order), the codebook from them, and dead codes (EMA
        count under the threshold) replaced by candidate rows of flat."""
        onehot = F.one_hot(idx, self.codebook_size).float()
        d = self.decay
        cluster_size = self.cluster_size * d + onehot.sum(0) * (1 - d)
        embed_avg = self.embed_avg * d + (onehot.t() @ flat) * (1 - d)
        n = cluster_size.sum()
        smoothed = (cluster_size + self.eps) / (n + self.codebook_size * self.eps) * n
        codebook = embed_avg / smoothed[:, None].clamp(min=1e-12)
        if self.threshold_ema_dead_code > 0:
            expired = cluster_size < self.threshold_ema_dead_code
            cand = _gather_candidates(generator, flat, self.codebook_size)
            codebook = torch.where(expired[:, None], cand, codebook)
            embed_avg = torch.where(expired[:, None], cand * self.threshold_ema_dead_code,
                                    embed_avg)
            cluster_size = torch.where(
                expired, torch.full_like(cluster_size, self.threshold_ema_dead_code),
                cluster_size)
        self.codebook.copy_(codebook)
        self.embed_avg.copy_(embed_avg)
        self.cluster_size.copy_(cluster_size)

    def forward(self, x, *, train: bool = False, generator=None):
        """(quantized, indices, commitment loss) of x (..., D). With train,
        kmeans-initialise an uninitialised codebook from x first, then, after
        the codes are picked, update the codebook by EMA; both draw from
        `generator`."""
        flat = x.detach().reshape(-1, self.dim).float()
        if train:
            if generator is None:
                raise ValueError("training the quantizer needs a torch.Generator")
            if not bool(self.initted):
                self._init_codebook(flat, generator)
        idx = self.encode(x, generator=generator if train else None)
        quantized = self.decode(idx).to(x.dtype)
        commit = self.commitment_weight * (quantized.float() - x.float()).square().mean()
        if train:
            self._ema_update(flat, idx.reshape(-1), generator)
        if self.rotation_trick:
            out = _rotate_to(x.reshape(-1, self.dim), quantized.reshape(-1, self.dim))
            out = out.reshape(x.shape).to(x.dtype)
        else:
            out = x + (quantized - x).detach()
        return out, idx, commit


class ResidualVQ(nn.Module):
    """`num_quantizers` codebooks, each quantizing what the ones before it
    left. With quantize_dropout, training keeps the quantizers up to one
    index drawn each call from [quantize_dropout_cutoff_index, Q) (rounded up
    to a multiple of quantize_dropout_multiple_of, less one) and drops the
    rest: code -1, no output, no loss, no state change."""

    def __init__(self, *, dim: int, num_quantizers: int, codebook_size: int,
                 decay: float = 0.95, commitment_weight: float = 1.0,
                 quantize_dropout: bool = False, quantize_dropout_cutoff_index: int = 0,
                 quantize_dropout_multiple_of: int = 1, kmeans_init: bool = True,
                 threshold_ema_dead_code: float = 2.0, rotation_trick: bool = True,
                 stochastic_sample_codes: bool = False, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            VectorQuantizeEMA(dim, codebook_size, decay=decay,
                              commitment_weight=commitment_weight,
                              threshold_ema_dead_code=threshold_ema_dead_code,
                              kmeans_init=kmeans_init, rotation_trick=rotation_trick,
                              stochastic_sample_codes=stochastic_sample_codes,
                              generator=generator)
            for _ in range(num_quantizers))
        self.dim = dim
        self.num_quantizers = num_quantizers
        self.codebook_size = codebook_size
        self.quantize_dropout = quantize_dropout and num_quantizers > 1
        self.quantize_dropout_cutoff_index = quantize_dropout_cutoff_index
        self.quantize_dropout_multiple_of = quantize_dropout_multiple_of

    @property
    def codebooks(self):
        return torch.stack([layer.codebook for layer in self.layers])  # (Q, C, D)

    def _last_kept(self, train: bool, generator) -> int:
        q = self.num_quantizers
        if not (train and self.quantize_dropout):
            return q - 1
        drop = draw_dropout_index(generator, self.quantize_dropout_cutoff_index, q)
        mult = self.quantize_dropout_multiple_of
        return ((drop + mult) // mult) * mult - 1

    def forward(self, x, *, train: bool = False, generator=None):
        """x (B, N, D) -> (quantized, indices (B, N, Q) int64 with -1 for a
        dropped quantizer, commitment losses (Q,))."""
        last = self._last_kept(train, generator)
        residual = x
        quantized_out = torch.zeros_like(x)
        all_idx, all_loss = [], []
        for qi, layer in enumerate(self.layers):
            if qi > last:
                all_idx.append(torch.full(x.shape[:-1], -1, dtype=torch.long, device=x.device))
                all_loss.append(torch.zeros((), device=x.device))
                continue
            quantized, idx, loss = layer(residual, train=train, generator=generator)
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

    def forward(self, x, *, train: bool = False, generator=None):
        """x (B, N, D) -> (quantized, indices (G, B, N, Q), losses (G, Q))."""
        outs, idxs, losses = zip(*(rvq(chunk, train=train, generator=generator)
                                   for rvq, chunk in zip(self.rvqs, x.chunk(self.groups, dim=-1))))
        return torch.cat(outs, -1), torch.stack(idxs), torch.stack(losses)

    def get_output_from_indices(self, indices):
        """indices (G, B, N, Q') -> (B, N, D)."""
        return torch.cat([rvq.get_output_from_indices(indices[g])
                          for g, rvq in enumerate(self.rvqs)], dim=-1)
