"""EnCodec (Meta's 24 kHz codec) as a SoundStream-shaped codec, held against
the JAX package's `models/encodec.py`: the SEANet causal convolution
encoder and decoder, each with a 2-layer LSTM and its skip connection
(`_LSTM`), and a residual VQ of `bandwidth` kbps (6 kbps at 75 Hz of
10-bit codes: 8 quantizers).

The surface is the codec's as the wrappers and AudioLM use it:
`target_sample_hz`, `codebook_dim`, `codebook_size`, `rq_groups` (1),
`num_quantizers`, `seq_len_multiple_of`, `downsample_factor`, the forward
giving (embeddings, codes (B, N, Q), None), `tokenize`, `decode` and
`decode_from_codebook_indices` of (B, N, Q) or (1, B, N, Q) codes.

The residual VQ is the port's `ResidualVQ` without kmeans init or dropout,
so on the card each of its searches is K6 (`ops/kernels/vq.py`); the
convolutions are cuDNN's and the LSTM is `torch.nn.LSTM` (gates i, f, g, o
as JAX's), all float32. Without a checkpoint the weights are drawn from
`seed`; `load_encodec_checkpoint` reads Meta's state dict
(`torch.load(weights_only=True)`), folding weight norm and copying the
codebooks in, by the JAX package's walk of `encoder.model.{i}` and
`decoder.model.{i}`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.conv import CausalConv1d, CausalConvTranspose1d
from ..ops.quantize import ResidualVQ
from ..ops.resample import resample
from ..ops.sampling import curtail_to_multiple

__all__ = ["EncodecWrapper"]


class _LSTM(nn.LSTM):
    """EnCodec's SLSTM: a 2-layer LSTM over (B, T, D), batch first, with
    its input added to its output. Weights uniform in +-1 / sqrt(dim) and
    zero biases, as JAX draws them."""

    def __init__(self, dim: int, layers: int = 2, *, generator=None):
        super().__init__(dim, dim, num_layers=layers, batch_first=True)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("weight"):
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) / math.sqrt(dim))
                else:
                    p.zero_()

    def forward(self, x):
        return x + super().forward(x)[0]


class _SEANetResBlock(nn.Module):
    def __init__(self, dim: int, *, generator=None):
        super().__init__()
        self.conv1 = CausalConv1d(dim, dim // 2, 3, generator=generator)
        self.conv2 = CausalConv1d(dim // 2, dim, 1, generator=generator)
        self.shortcut = CausalConv1d(dim, dim, 1, generator=generator)

    def forward(self, x):
        h = self.conv2(F.elu(self.conv1(F.elu(x))))
        return self.shortcut(x) + h


class EncodecWrapper(nn.Module):
    """EnCodec at `target_sample_hz` with SEANet `channels` doubled at each
    of `strides`, codes of `codebook_size` x `codebook_dim`, as many
    quantizers as `bandwidth` kbps buys at the frame rate. Built on the CPU
    from `seed` (or `checkpoint_path`, Meta's weights) and moved to
    `device`."""

    def __init__(self, *, target_sample_hz: int = 24000, strides=(2, 4, 5, 8),
                 channels: int = 32, codebook_dim: int = 128, codebook_size: int = 1024,
                 bandwidth: float = 6.0, checkpoint_path=None, seed: int = 0,
                 device: "str | torch.device" = "cuda"):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        frame_rate = target_sample_hz // int(np.prod(strides))
        self.num_quantizers = int(bandwidth * 1000 / (frame_rate * int(math.log2(codebook_size))))
        self.target_sample_hz = target_sample_hz
        self.strides = tuple(strides)
        self.codebook_dim = codebook_dim
        self.codebook_size = codebook_size
        self.rq_groups = 1
        self.pretrained = False

        ch = channels
        self.enc_init = CausalConv1d(1, ch, 7, generator=g)
        self.enc_blocks = nn.ModuleList()
        for s in self.strides:
            self.enc_blocks.append(nn.ModuleList([
                _SEANetResBlock(ch, generator=g),
                CausalConv1d(ch, ch * 2, 2 * s, stride=s, generator=g)]))
            ch *= 2
        self.enc_lstm = _LSTM(ch, generator=g)
        self.enc_final = CausalConv1d(ch, codebook_dim, 7, generator=g)
        self.rq = ResidualVQ(dim=codebook_dim, num_quantizers=self.num_quantizers,
                             codebook_size=codebook_size, kmeans_init=False,
                             quantize_dropout=False, generator=g)
        self.dec_init = CausalConv1d(codebook_dim, ch, 7, generator=g)
        self.dec_lstm = _LSTM(ch, generator=g)
        self.dec_blocks = nn.ModuleList()
        for s in reversed(self.strides):
            self.dec_blocks.append(nn.ModuleList([
                CausalConvTranspose1d(ch, ch // 2, 2 * s, stride=s, generator=g),
                _SEANetResBlock(ch // 2, generator=g)]))
            ch //= 2
        self.dec_final = CausalConv1d(ch, 1, 7, generator=g)
        if checkpoint_path is not None:
            self.load_encodec_checkpoint(checkpoint_path)
        self.to(device)

    @property
    def seq_len_multiple_of(self):
        return math.prod(self.strides)

    @property
    def downsample_factor(self):
        return self.seq_len_multiple_of

    def encode_frames(self, x):
        """waveform (B, T) -> embeddings (B, T / DS, codebook_dim)."""
        h = self.enc_init(x[..., None])
        for res, down in self.enc_blocks:
            h = down(F.elu(res(h)))
        return self.enc_final(F.elu(self.enc_lstm(h)))

    def decode_frames(self, h):
        """embeddings (B, N, codebook_dim) -> waveform (B, N * DS)."""
        h = self.dec_lstm(self.dec_init(h))
        for up, res in self.dec_blocks:
            h = res(up(F.elu(h)))
        return self.dec_final(F.elu(h))[..., 0]

    def forward(self, x, *, return_encoded: bool = False, input_sample_hz=None):
        """waveform (T,) or (B, T), resampled from input_sample_hz when given
        and curtailed to whole frames -> (quantized embeddings, codes (B, N,
        Q), None)."""
        if x.ndim == 1:
            x = x[None]
        if input_sample_hz is not None:
            x = resample(x, input_sample_hz, self.target_sample_hz)
        x = curtail_to_multiple(x, self.seq_len_multiple_of)
        q, codes, _ = self.rq(self.encode_frames(x))
        return q, codes, None

    def tokenize(self, audio, input_sample_hz=None):
        return self(audio, return_encoded=True, input_sample_hz=input_sample_hz)[1]

    def decode(self, emb, quantize: bool = False):
        if quantize:
            emb = self.rq(emb)[0]
        return self.decode_frames(emb)

    def decode_from_codebook_indices(self, indices):
        """codes (B, N, Q) or (1, B, N, Q), -1 for a dropped code ->
        waveform (B, N * DS)."""
        if indices.ndim == 4:
            indices = indices[0]
        return self.decode_frames(self.rq.get_output_from_indices(indices))

    @torch.no_grad()
    def load_encodec_checkpoint(self, path):
        """Meta's EnCodec weights (a state dict, or one under `best_state`
        or `state_dict`), read with torch.load(weights_only=True): weight
        norm folded as g v / (|v| over (1, 2) + 1e-12), a missing bias
        zero, the LSTMs' weights as they are, codebook q from
        `quantizer.vq.layers.{q}._codebook.embed`."""
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
        sd = ckpt.get("best_state", ckpt.get("state_dict", ckpt))
        sd = {k: v.float().numpy() for k, v in sd.items()}
        state = {}

        def weight(name):
            g, v = sd.get(f"{name}.weight_g"), sd.get(f"{name}.weight_v")
            if g is None:
                return sd[f"{name}.weight"]
            return g * v / (np.linalg.norm(v, axis=(1, 2), keepdims=True) + 1e-12)

        def conv(port, name, transposed=False):
            w, b = weight(name), sd.get(f"{name}.bias")
            state[f"{port}.weight"] = w
            state[f"{port}.bias"] = b if b is not None else np.zeros(w.shape[int(transposed)],
                                                                     np.float32)

        def res_block(port, li, side):
            for part, idx in (("conv1", "block.1"), ("conv2", "block.3"), ("shortcut", "shortcut")):
                conv(f"{port}.{part}", f"{side}.model.{li}.{idx}.conv.conv")

        def lstm(port, li, side):
            for j in range(2):
                for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    state[f"{port}.{kind}_l{j}"] = sd[f"{side}.model.{li}.lstm.{kind}_l{j}"]

        conv("enc_init", "encoder.model.0.conv.conv")
        li = 1
        for i in range(len(self.enc_blocks)):
            res_block(f"enc_blocks.{i}.0", li, "encoder")
            conv(f"enc_blocks.{i}.1", f"encoder.model.{li + 2}.conv.conv")
            li += 3
        lstm("enc_lstm", li, "encoder")
        conv("enc_final", f"encoder.model.{li + 2}.conv.conv")
        conv("dec_init", "decoder.model.0.conv.conv")
        lstm("dec_lstm", 1, "decoder")
        li = 3
        for i in range(len(self.dec_blocks)):
            conv(f"dec_blocks.{i}.0", f"decoder.model.{li}.convtr.convtr", transposed=True)
            res_block(f"dec_blocks.{i}.1", li + 2, "decoder")
            li += 3
        conv("dec_final", f"decoder.model.{li + 1}.conv.conv")
        for q, layer in enumerate(self.rq.layers):
            embed = sd[f"quantizer.vq.layers.{q}._codebook.embed"]
            state[f"rq.layers.{q}.codebook"] = embed
            state[f"rq.layers.{q}.embed_avg"] = embed
            state[f"rq.layers.{q}.cluster_size"] = layer.cluster_size
            state[f"rq.layers.{q}.initted"] = torch.tensor(True)
        self.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        self.pretrained = True
