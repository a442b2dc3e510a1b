"""HuBERT + k-means semantic tokenizer, held against the JAX package's
`models/hubert.py` (`HubertEncoder`, `HubertWithKmeans`): a convolutional
feature extractor (fairseq's hubert-base layout), a post-norm transformer
encoder without an attention mask (none is passed in JAX either), the
features of layer `output_layer`, and each frame's nearest k-means centre.

Frozen: the LM trainers tokenise audio with it under no_grad and never cast
it to bfloat16. Everything runs in float32: the attention is a plain
product with the softmax in float32 (the JAX package runs no Pallas kernel
here), and the nearest centre is argmin of |f|^2 - 2 f.c + |c|^2, a plain
product and argmin (not K6, whose formula drops |f|^2). Weights are drawn
from `seed` on the CPU, or read from a fairseq checkpoint
(`load_fairseq_checkpoint`) and k-means centres (`load_kmeans`).
Resampling is not ported: an input rate other than the target raises.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.layers import Linear, init_normal, init_uniform
from ..ops.resample import resample
from ..ops.sampling import curtail_to_multiple
from ..weights import hubert_state_dict_from_jax, read_npz

__all__ = ["HubertWithKmeans", "HubertEncoder", "load_hubert_with_kmeans"]

# fairseq hubert-base conv feature extractor: (dim, kernel, stride)
_CONV_SPEC = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
              (512, 3, 2), (512, 2, 2), (512, 2, 2))


class _ConvFeatureLayer(nn.Module):
    """VALID strided conv, weight (cout, cin, k), no bias; layer 0 adds
    fairseq's GroupNorm(512, 512), a per-channel norm over time (eps
    1e-5); then exact GELU. On (B, C, T)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, *, group_norm: bool = False,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(init_uniform((cout, cin, k), 1.0 / math.sqrt(cin * k),
                                                generator))
        self.stride = stride
        self.gn_scale = nn.Parameter(torch.ones(cout)) if group_norm else None
        self.gn_bias = nn.Parameter(torch.zeros(cout)) if group_norm else None

    def forward(self, x):
        y = F.conv1d(x, self.weight, stride=self.stride)
        if self.gn_scale is not None:
            m = y.mean(-1, keepdim=True)
            v = y.var(-1, unbiased=False, keepdim=True)
            y = (y - m) * torch.rsqrt(v + 1e-5) * self.gn_scale[:, None] + self.gn_bias[:, None]
        return F.gelu(y, approximate="none")


class _HubertSelfAttn(nn.Module):
    def __init__(self, dim: int, heads: int, *, generator=None):
        super().__init__()
        self.q, self.k, self.v, self.out = (Linear(dim, dim, generator=generator)
                                            for _ in range(4))
        self.heads, self.dim_head = heads, dim // heads

    def forward(self, x):
        b, n, d = x.shape
        h, dh = self.heads, self.dim_head
        q = self.q(x).view(b, n, h, dh).transpose(1, 2) * dh ** -0.5
        k = self.k(x).view(b, n, h, dh).transpose(1, 2)
        v = self.v(x).view(b, n, h, dh).transpose(1, 2)
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        o = torch.matmul(sim.softmax(-1), v.float()).to(x.dtype)
        return self.out(o.transpose(1, 2).reshape(b, n, d))


class _LN(nn.Module):
    """LayerNorm with weight and bias, in float32 (eps 1e-5)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), self.bias.float(),
                            1e-5).to(x.dtype)


class _HubertLayer(nn.Module):
    """Post-norm (fairseq hubert-base: layer_norm_first=False)."""

    def __init__(self, dim: int, heads: int, ff_dim: int, *, generator=None):
        super().__init__()
        self.attn = _HubertSelfAttn(dim, heads, generator=generator)
        self.ln1 = _LN(dim)
        self.fc1 = Linear(dim, ff_dim, generator=generator)
        self.fc2 = Linear(ff_dim, dim, generator=generator)
        self.ln2 = _LN(dim)

    def forward(self, x):
        x = self.ln1(x + self.attn(x))
        return self.ln2(x + self.fc2(F.gelu(self.fc1(x), approximate="none")))


class HubertEncoder(nn.Module):
    """Conv feature extractor + transformer encoder (hubert-base shapes)."""

    def __init__(self, *, dim: int = 768, heads: int = 12, ff_dim: int = 3072,
                 layers: int = 12, conv_pos_kernel: int = 128, conv_pos_groups: int = 16,
                 generator=None):
        super().__init__()
        convs, cin = [], 1
        for i, (cout, k, s) in enumerate(_CONV_SPEC):
            convs.append(_ConvFeatureLayer(cin, cout, k, s, group_norm=(i == 0),
                                           generator=generator))
            cin = cout
        self.conv_layers = nn.ModuleList(convs)
        self.post_extract_proj = Linear(512, dim, generator=generator)
        self.layer_norm_pre = _LN(512)
        lim = 1.0 / math.sqrt(dim // conv_pos_groups * conv_pos_kernel)
        self.pos_conv_weight = nn.Parameter(init_uniform(
            (dim, dim // conv_pos_groups, conv_pos_kernel), lim, generator))
        self.pos_conv_bias = nn.Parameter(torch.zeros(dim))
        self.pos_conv_groups = conv_pos_groups
        self.encoder_ln = _LN(dim)
        self.layers = nn.ModuleList(_HubertLayer(dim, heads, ff_dim, generator=generator)
                                    for _ in range(layers))
        self.dim = dim

    def extract_features(self, wav, output_layer: int):
        """wav (B, T) at 16 kHz -> the features (B, frames, dim) after the
        first `output_layer` layers."""
        x = wav.float()[:, None]
        for conv in self.conv_layers:
            x = conv(x)
        x = self.post_extract_proj(self.layer_norm_pre(x.transpose(1, 2)))
        # grouped positional conv, padded k // 2 both sides; an even kernel's
        # extra last frame is cropped, as fairseq does
        k = self.pos_conv_weight.shape[-1]
        pos = F.conv1d(x.transpose(1, 2), self.pos_conv_weight, self.pos_conv_bias,
                       padding=k // 2, groups=self.pos_conv_groups).transpose(1, 2)
        if k % 2 == 0:
            pos = pos[:, :-1]
        x = self.encoder_ln(x + F.gelu(pos, approximate="none"))
        for layer in self.layers[:output_layer]:
            x = layer(x)
        return x


class HubertWithKmeans(nn.Module):
    """waveform -> semantic ids: the features of `output_layer` and each
    frame's nearest centre of `cluster_centers` (codebook_size, dim), a
    buffer. Weights are drawn from `seed` on the CPU (centres 0.5 N(0, 1)),
    or loaded from `checkpoint_path` (fairseq HuBERT) and `kmeans_path`
    (`.npy`, or a joblib/sklearn pickle), then moved to `device`."""

    def __init__(self, checkpoint_path=None, kmeans_path=None, *,
                 target_sample_hz: int = 16000, seq_len_multiple_of: "int | None" = None,
                 output_layer: int = 9, codebook_size: int = 500, dim: int = 768,
                 num_layers: int = 12, heads: int = 12, ff_dim: "int | None" = None,
                 seed: int = 0, device: "str | torch.device" = "cuda"):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.encoder = HubertEncoder(dim=dim, layers=num_layers, heads=heads,
                                     ff_dim=ff_dim or 4 * dim, generator=g)
        self.register_buffer("cluster_centers", init_normal((codebook_size, dim), 0.5, g))
        self.output_layer = output_layer
        self.target_sample_hz = target_sample_hz
        self.seq_len_multiple_of = seq_len_multiple_of
        self.pretrained = False
        if checkpoint_path is not None:
            self.load_fairseq_checkpoint(checkpoint_path)
        if kmeans_path is not None:
            self.load_kmeans(kmeans_path)
        self.requires_grad_(False)
        self.to(device)

    @property
    def codebook_size(self) -> int:
        return self.cluster_centers.shape[0]

    @property
    def downsample_factor(self) -> int:
        # the conv stack's stride product: 16 kHz -> 50 Hz
        return 320

    @torch.no_grad()
    def load_fairseq_checkpoint(self, path, *, allow_pickle: bool = False):
        """Load a fairseq HuBERT checkpoint's state dict, mapped by name (no
        fairseq needed). Only a weights-only archive loads unless
        allow_pickle=True, which unpickles arbitrary objects: pass it only
        for a file you trust."""
        try:
            ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
        except Exception as e:
            if not allow_pickle:
                raise RuntimeError(
                    f"{path} requires unpickling arbitrary objects. If you trust this file, "
                    "call load_fairseq_checkpoint(path, allow_pickle=True).") from e
            ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
        sd = ckpt.get("model", ckpt.get("state_dict", ckpt))

        def put(param, name):
            param.copy_(torch.as_tensor(np.asarray(sd[name])).to(param.dtype))

        enc = self.encoder
        for i, conv in enumerate(enc.conv_layers):
            put(conv.weight, f"feature_extractor.conv_layers.{i}.0.weight")  # (out, in, k)
            if conv.gn_scale is not None:
                put(conv.gn_scale, f"feature_extractor.conv_layers.{i}.2.weight")
                put(conv.gn_bias, f"feature_extractor.conv_layers.{i}.2.bias")
        put(enc.post_extract_proj.weight, "post_extract_proj.weight")
        put(enc.post_extract_proj.bias, "post_extract_proj.bias")
        put(enc.layer_norm_pre.weight, "layer_norm.weight")
        put(enc.layer_norm_pre.bias, "layer_norm.bias")
        if "encoder.pos_conv.0.weight_g" in sd:
            # weight norm over the kernel's (out, in) axes
            wg = torch.as_tensor(np.asarray(sd["encoder.pos_conv.0.weight_g"]))
            wv = torch.as_tensor(np.asarray(sd["encoder.pos_conv.0.weight_v"]))
            w = wg * wv / (wv.norm(dim=(0, 1), keepdim=True) + 1e-12)
            enc.pos_conv_weight.copy_(w)
        else:
            put(enc.pos_conv_weight, "encoder.pos_conv.0.weight")
        put(enc.pos_conv_bias, "encoder.pos_conv.0.bias")
        put(enc.encoder_ln.weight, "encoder.layer_norm.weight")
        put(enc.encoder_ln.bias, "encoder.layer_norm.bias")
        names = (("attn.q", "self_attn.q_proj"), ("attn.k", "self_attn.k_proj"),
                 ("attn.v", "self_attn.v_proj"), ("attn.out", "self_attn.out_proj"),
                 ("ln1", "self_attn_layer_norm"), ("fc1", "fc1"), ("fc2", "fc2"),
                 ("ln2", "final_layer_norm"))
        for i, layer in enumerate(enc.layers):
            for ours, theirs in names:
                mod = layer.get_submodule(ours)
                put(mod.weight, f"encoder.layers.{i}.{theirs}.weight")
                put(mod.bias, f"encoder.layers.{i}.{theirs}.bias")
        self.pretrained = True

    @torch.no_grad()
    def load_kmeans(self, path):
        """The centres from a `.npy` file, or from a joblib/sklearn k-means
        pickle (joblib is imported only then)."""
        path = Path(path)
        if path.suffix == ".npy":
            centers = np.load(path)
        else:
            import joblib
            centers = joblib.load(path).cluster_centers_
        self.cluster_centers = torch.as_tensor(np.asarray(centers, np.float32)).to(
            self.cluster_centers.device)

    @torch.no_grad()
    def forward(self, wav_input, flatten: bool = True, input_sample_hz=None):
        """wav_input (B, T) -> ids (B, frames), int64; resampled from
        input_sample_hz to target_sample_hz first when given."""
        if input_sample_hz is not None:
            wav_input = resample(wav_input, input_sample_hz, self.target_sample_hz)
        if self.seq_len_multiple_of is not None:
            wav_input = curtail_to_multiple(wav_input, self.seq_len_multiple_of)
        f = self.encoder.extract_features(wav_input, self.output_layer).float()
        c = self.cluster_centers.float()
        dist = f.square().sum(-1, keepdim=True) - 2 * f @ c.t() + c.square().sum(-1)
        ids = dist.argmin(-1)
        return ids.reshape(ids.shape[0], -1) if flatten else ids


def load_hubert_with_kmeans(path, *, device: "str | torch.device" = "cuda"):
    """A HubertWithKmeans from a JAX `.npz` checkpoint of one (its config
    and weights, centres included)."""
    meta, arrays = read_npz(path)
    model = HubertWithKmeans(**meta["config"], device="cpu")
    model.load_state_dict(hubert_state_dict_from_jax(arrays))
    return model.to(resolve_device(device))
