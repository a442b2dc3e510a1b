"""The vq-wav2vec semantic tokenizer, held against the JAX package's
`models/vq_wav2vec.py`: fairseq's `ConvFeatureExtractionModel` (blocks of a
bias-free convolution, a one-group GroupNorm in float32 and ReLU, with
optional same-width skip connections scaled by sqrt(residual_scale) and
optional log(1 + |x|) compression) and its `KmeansVectorQuantizer` (a
grouped 1x1 projection, a GroupNorm of `groups` groups and, per group, the
nearest of `codebook_size` codewords, shared by the groups with
`combine_groups`).

The released vq-wav2vec's encoder is `_VQW2V_ENC_SPEC` (eight convolutions,
strides 5, 4, 2, 2, 2, 1, 1, 1): `downsample_factor` is their product,
160. The ids are (B, frames, groups), or (B, frames * groups) flattened
(the groups of a frame next to each other).

The nearest codeword is a plain float32 product and argmin per group, the
distance with |z|^2 in it, as JAX computes it (not K6, whose formula
drops |z|^2 and would break near ties another way). Without a checkpoint
the weights are drawn from `seed`; `load_fairseq_checkpoint` rebuilds the
model from the checkpoint's saved args and reads its weights, unpickling
only with allow_pickle=True (fairseq stores its args as a pickled
Namespace).
"""
from __future__ import annotations

import ast
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.layers import init_uniform
from ..ops.resample import resample
from ..ops.sampling import curtail_to_multiple

__all__ = ["FairseqVQWav2Vec"]

# the released vq-wav2vec (kmeans) encoder: (channels, kernel, stride) a layer
_VQW2V_ENC_SPEC = ((512, 10, 5), (512, 8, 4), (512, 4, 2), (512, 4, 2),
                   (512, 4, 2), (512, 1, 1), (512, 1, 1), (512, 1, 1))


def _group_norm(x, num_groups: int, weight, bias, eps: float = 1e-5):
    """fairseq's Fp32GroupNorm of x (B, T, C): each sample normalised over
    (its group's channels x time), in float32, then scaled and shifted."""
    b, t, c = x.shape
    xg = x.float().reshape(b, t, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, t, c)
    return (y * weight.float() + bias.float()).to(x.dtype)


class _ConvBlock(nn.Module):
    """Conv1d (bias-free, unpadded) -> GroupNorm(1, C) -> ReLU on (B, T, C)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, *, generator=None):
        super().__init__()
        self.weight = nn.Parameter(init_uniform((cout, cin, k), 1.0 / math.sqrt(cin * k),
                                                generator))
        self.norm_weight = nn.Parameter(torch.ones(cout))
        self.norm_bias = nn.Parameter(torch.zeros(cout))
        self.stride = stride

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype), stride=self.stride)
        return F.relu(_group_norm(y.transpose(1, 2), 1, self.norm_weight, self.norm_bias))


class _KmeansVQ(nn.Module):
    """fairseq's KmeansVectorQuantizer at inference: the grouped projection
    (one (in, out) matrix a group), GroupNorm(groups), and each group's
    nearest codeword of `embedding` (V, banks, D / groups)."""

    def __init__(self, dim: int, num_vars: int, groups: int, combine_groups: bool, *,
                 generator=None):
        super().__init__()
        var_dim = dim // groups
        banks = 1 if combine_groups else groups
        self.embedding = nn.Parameter(0.01 * torch.randn(num_vars, banks, var_dim,
                                                         generator=generator))
        self.proj_weight = nn.Parameter(init_uniform((groups, var_dim, var_dim),
                                                     1.0 / math.sqrt(var_dim), generator))
        self.norm_weight = nn.Parameter(torch.ones(dim))
        self.norm_bias = nn.Parameter(torch.zeros(dim))
        self.groups = groups
        self.combine_groups = combine_groups

    @property
    def num_vars(self):
        return self.embedding.shape[0]

    def forward(self, x):
        """x (B, T, D) -> ids (B, T, groups), int64."""
        b, t, d = x.shape
        g = self.groups
        xg = x.float().reshape(b, t, g, d // g)
        ze = torch.einsum("btgd,gde->btge", xg, self.proj_weight.float())
        ze = _group_norm(ze.reshape(b, t, d), g, self.norm_weight,
                         self.norm_bias).reshape(b, t, g, d // g)
        cb = self.embedding.float().expand(-1, g, -1)  # (V, G, D / G)
        dist = (ze.square().sum(-1, keepdim=True)
                - 2 * torch.einsum("btgd,vgd->btgv", ze, cb)
                + cb.square().sum(-1).t()[None, None])
        return dist.argmin(-1)


class FairseqVQWav2Vec(nn.Module):
    """The vq-wav2vec tokenizer: `codebook_size`, `groups`,
    `downsample_factor`, `target_sample_hz`; forward gives the grouped
    codeword ids. Built on the CPU from `seed` (or `checkpoint_path`) and
    moved to `device`."""

    def __init__(self, checkpoint_path=None, *, target_sample_hz: int = 24000,
                 conv_spec=_VQW2V_ENC_SPEC, codebook_size: int = 320, num_groups: int = 2,
                 combine_groups: bool = False, skip_connections: bool = False,
                 residual_scale: float = 0.5, log_compression: bool = False,
                 seq_len_multiple_of: "int | None" = None, allow_pickle: bool = False,
                 seed: int = 0, device: "str | torch.device" = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self._build(conv_spec, codebook_size, num_groups, combine_groups, seed)
        self.skip_connections = skip_connections
        self.residual_scale = math.sqrt(residual_scale)
        self.log_compression = log_compression
        self.target_sample_hz = target_sample_hz
        self.seq_len_multiple_of = seq_len_multiple_of
        self.pretrained = False
        if checkpoint_path is not None:
            self.load_fairseq_checkpoint(checkpoint_path, allow_pickle=allow_pickle)
        self.to(device)

    def _build(self, conv_spec, codebook_size, num_groups, combine_groups, seed):
        g = torch.Generator().manual_seed(seed)
        self.conv_spec = tuple(tuple(int(v) for v in s) for s in conv_spec)
        self.encoder = nn.ModuleList()
        cin = 1
        for cout, k, stride in self.conv_spec:
            self.encoder.append(_ConvBlock(cin, cout, k, stride, generator=g))
            cin = cout
        if cin % num_groups:
            raise ValueError(f"{cin} channels do not split into {num_groups} groups")
        self.vq = _KmeansVQ(cin, codebook_size, num_groups, combine_groups, generator=g)
        self.num_groups = num_groups

    @property
    def groups(self):
        return self.num_groups

    @property
    def downsample_factor(self):
        return math.prod(s for _, _, s in self.conv_spec)

    @property
    def codebook_size(self):
        return self.vq.num_vars

    @torch.no_grad()
    def load_fairseq_checkpoint(self, path, *, allow_pickle: bool = False):
        """A fairseq vq-wav2vec checkpoint: the architecture rebuilt from its
        `args` (conv_feature_layers, vq_vars, vq_groups, combine_groups,
        skip_connections_feat, residual_scale, log_compression), then its
        weights. torch.load(weights_only=True) first; a file that needs
        unpickling (every real fairseq checkpoint) loads only with
        allow_pickle=True, for files from a trusted source, and raises
        otherwise."""
        try:
            ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
        except Exception as e:
            if not allow_pickle:
                raise RuntimeError(
                    f"{path} requires unpickling arbitrary objects (fairseq stores its args as "
                    f"a pickled Namespace). If you trust this file, call "
                    f"load_fairseq_checkpoint(path, allow_pickle=True).") from e
            ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
        args = ckpt.get("args")
        sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
        sd = {k: v.detach().float() for k, v in sd.items()}
        device = next(self.parameters()).device
        if args is not None:
            def get(name, default):
                return getattr(args, name, default)

            spec = get("conv_feature_layers", None)
            spec = ast.literal_eval(spec) if isinstance(spec, str) else (spec or _VQW2V_ENC_SPEC)
            emb = sd.get("vector_quantizer.embedding")
            num_vars = emb.shape[0] if emb is not None else int(get("vq_vars", 320))
            groups = int(get("vq_groups", 2))
            combine = (emb is not None and emb.shape[1] == 1 and groups > 1) \
                or bool(get("combine_groups", False))
            self._build(spec, num_vars, groups, combine, 0)
            self.skip_connections = bool(get("skip_connections_feat", False))
            self.residual_scale = math.sqrt(float(get("residual_scale", 0.5)))
            self.log_compression = bool(get("log_compression", False))
        for i, block in enumerate(self.encoder):
            pre = f"feature_extractor.conv_layers.{i}"
            if f"{pre}.0.weight" in sd:
                block.weight.copy_(sd[f"{pre}.0.weight"])
            for ni in (2, 1):  # the norm's index, with and without dropout before it
                w = sd.get(f"{pre}.{ni}.weight")
                if w is not None and w.ndim == 1:
                    block.norm_weight.copy_(w)
                    block.norm_bias.copy_(sd[f"{pre}.{ni}.bias"])
                    break
        if "vector_quantizer.embedding" in sd:
            self.vq.embedding.copy_(sd["vector_quantizer.embedding"])
        pw = sd.get("vector_quantizer.projection.0.weight")
        if pw is not None:  # grouped 1x1 conv (D, D / G, 1): y = W x a group
            g = self.vq.groups
            d, dg = pw.shape[0], pw.shape[1]
            self.vq.proj_weight.copy_(pw.reshape(g, d // g, dg).transpose(1, 2))
        nw = sd.get("vector_quantizer.projection.1.weight")
        if nw is not None:
            self.vq.norm_weight.copy_(nw)
            self.vq.norm_bias.copy_(sd["vector_quantizer.projection.1.bias"])
        self.to(device)
        self.pretrained = True

    def _features(self, wav):
        """waveform (B, T) -> the encoder's features (B, frames, C)."""
        x = wav[..., None]
        for block in self.encoder:
            residual = x
            x = block(x)
            if self.skip_connections and x.shape[-1] == residual.shape[-1]:
                residual = residual[:, :: residual.shape[1] // x.shape[1]][:, : x.shape[1]]
                x = (x + residual) * self.residual_scale
        return torch.log1p(x.abs()) if self.log_compression else x

    @torch.no_grad()
    def forward(self, wav_input, flatten: bool = True, input_sample_hz=None):
        """waveform (B, T) -> ids (B, frames, groups), or (B, frames *
        groups) with flatten; resampled from input_sample_hz first when
        given."""
        if input_sample_hz is not None:
            wav_input = resample(wav_input, input_sample_hz, self.target_sample_hz)
        if self.seq_len_multiple_of is not None:
            wav_input = curtail_to_multiple(wav_input, self.seq_len_multiple_of)
        ids = self.vq(self._features(wav_input.float()))
        return ids.reshape(ids.shape[0], -1) if flatten else ids
