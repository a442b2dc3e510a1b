"""The SoundStream codec at serving time, held against the JAX package's
`models/soundstream.py`: waveform -> codes (`tokenize`), codes -> waveform
(`decode_from_codebook_indices`), and the forward's serving modes.

Activations are channels-last (B, T, C) as in JAX, in float32. The
bottleneck's local attention is K7 and the quantizer's nearest-code search
K6. Not ported: training (the quantizer's EMA update and kmeans init, the
discriminators, the GAN, mel, STFT and SI-SNR losses), the lookup-free and
finite-scalar quantizers, squeeze-excite, GateLoop layers, resampling and a
bfloat16 compute type; each raises where it would be asked for.
"""
from __future__ import annotations

import functools
import inspect

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.layers import Linear
from ..ops.attention import LocalTransformer
from ..ops.conv import CausalConv1d, CausalConvTranspose1d
from ..ops.quantize import GroupedResidualVQ
from ..ops.sampling import curtail_to_multiple
from ..weights import codec_state_dict_from_jax, read_npz

__all__ = ["SoundStream", "AudioLMSoundStream", "load_soundstream"]


class FiLM(nn.Module):
    """Per-channel scale and shift from a conditioning vector."""

    def __init__(self, dim: int, dim_cond: int, *, generator=None):
        super().__init__()
        self.to_cond = Linear(dim_cond, dim * 2, generator=generator)

    def forward(self, x, cond):
        gamma, beta = self.to_cond(cond.to(x.dtype)).chunk(2, dim=-1)
        return x * gamma + beta


class ResidualUnit(nn.Module):
    """conv(7, dilated) -> ELU -> conv(1) -> ELU, residual."""

    def __init__(self, chan_in: int, chan_out: int, dilation: int, *, generator=None):
        super().__init__()
        self.conv1 = CausalConv1d(chan_in, chan_out, 7, dilation=dilation, generator=generator)
        self.conv2 = CausalConv1d(chan_out, chan_out, 1, generator=generator)

    def forward(self, x):
        return F.elu(self.conv2(F.elu(self.conv1(x)))) + x


class EncoderBlock(nn.Module):
    def __init__(self, chan_in: int, chan_out: int, stride: int, cycle_dilations=(1, 3, 9), *,
                 generator=None):
        super().__init__()
        d = list(cycle_dilations)
        self.res1, self.res2, self.res3 = (
            ResidualUnit(chan_in, chan_in, d[i % len(d)], generator=generator) for i in range(3))
        self.down = CausalConv1d(chan_in, chan_out, 2 * stride, stride=stride,
                                 generator=generator)

    def forward(self, x):
        return self.down(self.res3(self.res2(self.res1(x))))


class DecoderBlock(nn.Module):
    def __init__(self, chan_in: int, chan_out: int, stride: int, cycle_dilations=(1, 3, 9), *,
                 generator=None):
        super().__init__()
        d = list(cycle_dilations)
        self.up = CausalConvTranspose1d(chan_in, chan_out, 2 * stride, stride=stride,
                                        generator=generator)
        self.res1, self.res2, self.res3 = (
            ResidualUnit(chan_out, chan_out, d[i % len(d)], generator=generator)
            for i in range(3))

    def forward(self, x):
        return self.res3(self.res2(self.res1(self.up(x))))


class SoundStream(nn.Module):
    """Encoder (causal conv blocks, then local attention) -> grouped residual
    VQ -> decoder (local attention, then causal transposed-conv blocks), at
    `target_sample_hz`. Weights are drawn from `seed` on the CPU and moved to
    `device`; the codebooks start at zeros, as the JAX package's do under
    kmeans init, until a checkpoint or the caller fills them."""

    def __init__(self, *, channels: int = 32, strides=(2, 4, 5, 8),
                 channel_mults=(2, 4, 8, 16), codebook_dim: int = 512,
                 codebook_size: int = 1024, rq_num_quantizers: int = 8,
                 rq_commitment_weight: float = 1.0, rq_groups: int = 1,
                 rq_rotation_trick: bool = True, enc_cycle_dilations=(1, 3, 9),
                 dec_cycle_dilations=(1, 3, 9), target_sample_hz: int = 16000,
                 use_local_attn: bool = True, attn_window_size: int = 128,
                 attn_dim_head: int = 64, attn_heads: int = 8, attn_depth: int = 1,
                 attn_xpos_scale_base: "float | None" = None,
                 attn_dynamic_pos_bias: bool = False, seed: int = 0,
                 device: "str | torch.device" = "cuda"):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.target_sample_hz = target_sample_hz
        self.strides = tuple(strides)
        self.channels = channels
        self.codebook_dim = codebook_dim
        self.codebook_size = codebook_size
        self.rq_groups = rq_groups
        self.num_quantizers = rq_num_quantizers

        layer_channels = (channels, *(m * channels for m in channel_mults))
        pairs = tuple(zip(layer_channels[:-1], layer_channels[1:]))
        self.encoder_init = CausalConv1d(1, channels, 7, generator=g)
        self.encoder_blocks = nn.ModuleList(
            EncoderBlock(ci, co, s, enc_cycle_dilations, generator=g)
            for (ci, co), s in zip(pairs, self.strides))
        self.encoder_final = CausalConv1d(layer_channels[-1], codebook_dim, 3, generator=g)
        attn_kw = dict(dim=codebook_dim, dim_head=attn_dim_head, heads=attn_heads,
                       depth=attn_depth, window_size=attn_window_size,
                       xpos_scale_base=attn_xpos_scale_base,
                       dynamic_pos_bias=attn_dynamic_pos_bias)
        self.encoder_attn = LocalTransformer(**attn_kw, generator=g) if use_local_attn else None
        self.encoder_film = FiLM(codebook_dim, 2, generator=g)
        self.rq = GroupedResidualVQ(dim=codebook_dim, groups=rq_groups,
                                    num_quantizers=rq_num_quantizers,
                                    codebook_size=codebook_size,
                                    commitment_weight=rq_commitment_weight,
                                    rotation_trick=rq_rotation_trick)
        self.decoder_film = FiLM(codebook_dim, 2, generator=g)
        self.decoder_attn = LocalTransformer(**attn_kw, generator=g) if use_local_attn else None
        self.decoder_init = CausalConv1d(codebook_dim, layer_channels[-1], 7, generator=g)
        self.decoder_blocks = nn.ModuleList(
            DecoderBlock(co, ci, s, dec_cycle_dilations, generator=g)
            for (ci, co), s in zip(reversed(pairs), reversed(self.strides)))
        self.decoder_final = CausalConv1d(channels, 1, 7, generator=g)
        self.to(device)

    @property
    def seq_len_multiple_of(self):
        return functools.reduce(lambda a, b: a * b, self.strides)

    @property
    def downsample_factor(self):
        return self.seq_len_multiple_of

    def process_input(self, x, input_sample_hz=None):
        """(T,), (B, T) or (B, 1, T) -> (B, T') curtailed to a multiple of
        the downsample factor. Resampling is not ported: an input_sample_hz
        other than target_sample_hz raises."""
        if input_sample_hz is not None and input_sample_hz != self.target_sample_hz:
            raise NotImplementedError(f"resampling {input_sample_hz} Hz to "
                                      f"{self.target_sample_hz} Hz is not ported")
        if x.ndim == 1:
            x = x[None]
        if x.ndim == 3:
            x = x[:, 0]
        return curtail_to_multiple(x, self.seq_len_multiple_of)

    def encode_frames(self, x):
        """waveform (B, T) -> pre-quantization embeddings (B, T / DS, D)."""
        h = self.encoder_init(x.float()[..., None])
        for block in self.encoder_blocks:
            h = block(h)
        h = self.encoder_final(h)
        return self.encoder_attn(h) if self.encoder_attn is not None else h

    def decode(self, x):
        """quantized embeddings (B, N, D) -> waveform (B, N * DS)."""
        x = x.float()
        if self.decoder_attn is not None:
            x = self.decoder_attn(x)
        h = self.decoder_init(x)
        for block in self.decoder_blocks:
            h = block(h)
        return self.decoder_final(h)[..., 0]

    def tokenize(self, audio, input_sample_hz=None):
        """waveform -> codes (G, B, N, Q)."""
        return self(audio, return_codes_only=True, input_sample_hz=input_sample_hz)

    def decode_from_codebook_indices(self, quantized_indices):
        """codes (G, B, N, Q) or (B, N, G * Q), -1 for a dropped code ->
        waveform (B, N * DS)."""
        if quantized_indices.ndim == 3:
            b, n, gq = quantized_indices.shape
            g = self.rq_groups
            quantized_indices = quantized_indices.reshape(b, n, g, gq // g).permute(2, 0, 1, 3)
        return self.decode(self.rq.get_output_from_indices(quantized_indices))

    def forward(self, x, *, target=None, is_denoising: "bool | None" = None,
                return_encoded: bool = False, return_codes_only: bool = False,
                return_recons_only: bool = False, input_sample_hz=None, train: bool = False):
        """The serving modes of the JAX forward, in eval mode: the codes
        (G, B, N, Q) with return_codes_only; (quantized, codes (B, N, G * Q),
        commitment losses (G, Q)) with return_encoded; the reconstruction
        with return_recons_only. is_denoising (which needs a target, as in
        JAX) conditions the encoder and decoder by FiLM. The training losses
        are not ported: train, or no return mode, raises."""
        if train:
            raise NotImplementedError("codec training is not ported")
        if is_denoising is not None and target is None:
            raise ValueError("is_denoising needs a target")
        x = self.process_input(x, input_sample_hz)
        h = self.encode_frames(x)
        cond = None
        if is_denoising is not None:
            cond = torch.tensor([1.0, 0.0] if is_denoising else [0.0, 1.0], device=h.device)
            h = self.encoder_film(h, cond)
        hq, indices, commit_loss = self.rq(h)
        if return_codes_only:
            return indices
        if return_encoded:
            g, b, n, q = indices.shape
            return hq, indices.permute(1, 2, 0, 3).reshape(b, n, g * q), commit_loss
        if cond is not None:
            hq = self.decoder_film(hq, cond)
        recon = self.decode(hq)
        if return_recons_only:
            return recon
        raise NotImplementedError("the codec's training losses are not ported: ask for "
                                  "return_codes_only, return_encoded or return_recons_only")


def AudioLMSoundStream(strides=(2, 4, 5, 8), target_sample_hz=16000, rq_num_quantizers=12,
                       **kwargs):
    """The AudioLM preset of the JAX package: 16 kHz, 50 frames a second,
    12 quantizers."""
    return SoundStream(strides=strides, target_sample_hz=target_sample_hz,
                       rq_num_quantizers=rq_num_quantizers, **kwargs)


# config keys of a JAX checkpoint that serving does not read: the training
# losses and their weights, the discriminators, the mel and STFT loss
# settings, the quantizer's EMA and dropout settings
_INERT_KEYS = (
    "recon_loss_weight", "multi_spectral_recon_loss_weight", "multi_stft_recon_loss_weight",
    "si_snr_loss_weight", "adversarial_loss_weight", "feature_loss_weight",
    "multi_spectral_window_powers_of_two", "multi_spectral_n_ffts", "multi_spectral_n_mels",
    "multi_stft_resolutions", "multi_stft_term_weights", "discr_multi_scales",
    "stft_normalized", "complex_stft_discr_logits_abs", "complex_stft_discr_kwargs",
    "multi_scale_discr_kwargs", "rq_ema_decay", "rq_quantize_dropout_multiple_of",
    "quantize_dropout_cutoff_index")
# rq_kwargs that only training reads
_INERT_RQ_KWARGS = ("kmeans_init", "threshold_ema_dead_code", "quantize_dropout")
# what the port does not have: a checkpoint must hold these values
_UNPORTED = {"use_lookup_free_quantizer": False, "use_finite_scalar_quantizer": False,
             "finite_scalar_quantizer_levels": None, "squeeze_excite": False,
             "use_gate_loop_layers": False, "rq_stochastic_sample_codes": False,
             "input_channels": 1, "compute_dtype": "float32", "pad_mode": "reflect"}


def load_soundstream(path, *, device: "str | torch.device" = "cuda"):
    """A SoundStream from a JAX `.npz` checkpoint (`SoundStream.save`, or a
    persisted trainer checkpoint with its config), in float32. Every config
    key is a constructor argument, one of the keys serving does not read
    (`_INERT_KEYS`; `rq_kwargs` may hold only `_INERT_RQ_KWARGS`), or an
    unported feature at its default (`_UNPORTED`); anything else raises. The
    GAN discriminators' weights, `discriminators.*` and
    `stft_discriminator.*` (`weights.CODEC_UNUSED`), are not loaded."""
    device = resolve_device(device)
    meta, arrays = read_npz(path)
    cfg = {k: v for k, v in meta["config"].items() if k not in _INERT_KEYS}
    for key, value in _UNPORTED.items():
        if cfg.pop(key, value) != value:
            raise NotImplementedError(f"{path}: {key}={meta['config'][key]!r} is not ported")
    extra = sorted(set(cfg.pop("rq_kwargs", None) or {}) - set(_INERT_RQ_KWARGS))
    if extra:
        raise NotImplementedError(f"{path}: rq_kwargs {extra} are not honoured by the port")
    unknown = sorted(set(cfg) - set(inspect.signature(SoundStream).parameters)
                     - {"seed", "device"})
    if unknown:
        raise NotImplementedError(f"{path}: config keys {unknown} are not honoured by the port")
    model = SoundStream(**cfg, device="cpu")
    model.load_state_dict(codec_state_dict_from_jax(arrays))
    return model.to(device)
