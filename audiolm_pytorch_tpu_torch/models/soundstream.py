"""The SoundStream codec, held against the JAX package's
`models/soundstream.py`: waveform -> codes (`tokenize`), codes -> waveform
(`decode_from_codebook_indices`), the forward's serving modes, and its
training: the forward's loss breakdown (reconstruction, multi-scale mel,
multi-resolution STFT, SI-SNR, adversarial and feature-matching losses and
the quantizers' commitment losses, in JAX's order) and the discriminators'
hinge loss with its gradient penalty, over a multi-scale waveform
discriminator and a complex STFT discriminator.

Activations are channels-last (B, T, C) as in JAX, in float32; the
discriminators run channels-first inside. The bottleneck's local attention
is K7 and the quantizer's nearest-code search K6, in training as in
serving. Not ported: the lookup-free and finite-scalar quantizers,
squeeze-excite, GateLoop layers, resampling and a bfloat16 compute type;
each raises where it would be asked for.
"""
from __future__ import annotations

import functools
import inspect
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..nn.layers import Linear, init_uniform
from ..ops.attention import LocalTransformer
from ..ops.conv import CausalConv1d, CausalConvTranspose1d
from ..ops.quantize import GroupedResidualVQ
from ..ops.sampling import curtail_to_multiple
from ..ops.stft import melspectrogram, stft
from ..utils.metrics import si_snr
from ..weights import DISCRIMINATORS, codec_state_dict_from_jax, read_npz

__all__ = ["SoundStream", "AudioLMSoundStream", "load_soundstream", "MultiScaleDiscriminator",
           "ComplexSTFTDiscriminator", "hinge_discr_loss", "hinge_gen_loss", "avg_pool1d"]


def hinge_discr_loss(fake, real):
    return (F.relu(1 + fake.float()) + F.relu(1 - real.float())).mean()


def hinge_gen_loss(fake):
    return -fake.float().mean()


def _safe_log(t, eps: float = 1e-20):
    return torch.log(t.clamp(min=eps))


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


class _Conv1dLayer(nn.Module):
    """A zero-padded (non-causal) grouped convolution of the discriminators,
    on (B, C, T); weight (out, in / groups, K)."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1, padding: int = 0,
                 groups: int = 1, generator=None):
        super().__init__()
        lim = 1.0 / math.sqrt(cin // groups * k)
        self.weight = nn.Parameter(init_uniform((cout, cin // groups, k), lim, generator))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.stride, self.padding, self.groups = stride, padding, groups

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, stride=self.stride, padding=self.padding,
                        groups=self.groups)


class MultiScaleDiscriminator(nn.Module):
    """Waveform convolution discriminator; with return_intermediates also
    each strided layer's activations, (B, C, T'), for the feature loss."""

    def __init__(self, *, channels: int = 16, layers: int = 4, groups=(4, 16, 64, 256),
                 chan_max: int = 1024, input_channels: int = 1, generator=None):
        super().__init__()
        self.init_conv = _Conv1dLayer(input_channels, channels, 15, padding=7,
                                      generator=generator)
        self.conv_layers = nn.ModuleList()
        curr = channels
        for _, group in zip(range(layers), groups):
            chan_out = min(curr * 4, chan_max)
            self.conv_layers.append(_Conv1dLayer(curr, chan_out, 41, stride=4, padding=20,
                                                 groups=group, generator=generator))
            curr = chan_out
        self.final_conv1 = _Conv1dLayer(curr, curr, 5, padding=2, generator=generator)
        self.final_conv2 = _Conv1dLayer(curr, 1, 3, padding=1, generator=generator)

    def forward(self, x, return_intermediates: bool = False):
        """x: (B, T) waveform -> logits (B, 1, T')."""
        h = self.init_conv(x[:, None])
        intermediates = []
        for layer in self.conv_layers:
            h = F.leaky_relu(layer(h), 0.1)
            intermediates.append(h)
        out = self.final_conv2(F.leaky_relu(self.final_conv1(h), 0.1))
        return (out, intermediates) if return_intermediates else out


class ComplexConv2d(nn.Module):
    """A complex convolution on (real, imag) pairs (B, C, F, T) as two real
    convolutions: real with (wr, wi) and imag with (-wi, wr) stacked along
    the outputs, then added. Weights (out, in, kh, kw)."""

    def __init__(self, cin: int, cout: int, kernel_size, *, stride=1, padding=0,
                 generator=None):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        lim = 1.0 / math.sqrt(cin * kh * kw)
        self.wr = nn.Parameter(init_uniform((cout, cin, kh, kw), lim, generator))
        self.wi = nn.Parameter(init_uniform((cout, cin, kh, kw), lim, generator))
        self.br = nn.Parameter(torch.zeros(cout))
        self.bi = nn.Parameter(torch.zeros(cout))
        self.stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
        self.padding = (padding, padding) if isinstance(padding, int) else tuple(padding)

    def forward(self, xr, xi):
        conv = functools.partial(F.conv2d, stride=self.stride, padding=self.padding)
        from_re = conv(xr, torch.cat([self.wr, self.wi]))
        from_im = conv(xi, torch.cat([-self.wi, self.wr]))
        yr, yi = (from_re + from_im).chunk(2, dim=1)
        return yr + self.br[:, None, None], yi + self.bi[:, None, None]


class ModReLU(nn.Module):
    """relu(|z| + b) z / |z|, |z| with 1e-6 under the root (it bounds the
    second derivative the gradient penalty takes near z = 0)."""

    def __init__(self):
        super().__init__()
        self.b = nn.Parameter(torch.zeros(()))

    def forward(self, xr, xi):
        mag = torch.sqrt(xr * xr + xi * xi + 1e-6)
        scale = F.relu(mag + self.b) / mag
        return xr * scale, xi * scale


class ComplexSTFTResidualUnit(nn.Module):
    def __init__(self, chan_in: int, chan_out: int, strides, *, generator=None):
        super().__init__()
        ks = tuple(s + 2 for s in strides)
        self.conv1 = ComplexConv2d(chan_in, chan_in, 3, padding=1, generator=generator)
        self.act = ModReLU()
        self.conv2 = ComplexConv2d(chan_in, chan_in, 3, padding=1, generator=generator)
        self.down = ComplexConv2d(chan_in, chan_out, ks, stride=strides,
                                  padding=tuple(k // 2 for k in ks), generator=generator)

    def forward(self, xr, xi):
        hr, hi = self.conv2(*self.act(*self.conv1(xr, xi)))
        return self.down(xr + hr, xi + hi)


class ComplexSTFTDiscriminator(nn.Module):
    """The complex STFT discriminator: complex convolutions over the
    (frequency, frame) plane of the waveform's STFT. Logits (B, 1, F', T')
    as |z| (with 1e-6 under the root), or (B, 1, F', T', 2) as (re, im);
    intermediates (B, 2C, F', T'), the real channels then the imaginary."""

    def __init__(self, *, channels: int = 32,
                 strides=((1, 2), (2, 2), (1, 2), (2, 2), (1, 2), (2, 2)),
                 chan_mults=(1, 2, 4, 4, 8, 8), input_channels: int = 1, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int = 1024, stft_normalized: bool = False,
                 logits_abs: bool = True, generator=None):
        super().__init__()
        self.init_conv = ComplexConv2d(input_channels, channels, 7, padding=3,
                                       generator=generator)
        layer_channels = (channels, *(m * channels for m in chan_mults))
        self.layers = nn.ModuleList(
            ComplexSTFTResidualUnit(ci, co, tuple(s), generator=generator)
            for ci, co, s in zip(layer_channels[:-1], layer_channels[1:], strides))
        self.final_conv = ComplexConv2d(layer_channels[-1], 1, (16, 1), generator=generator)
        self.n_fft, self.hop_length, self.win_length = n_fft, hop_length, win_length
        self.stft_normalized = stft_normalized
        self.logits_abs = logits_abs

    def forward(self, x, return_intermediates: bool = False):
        """x: (B, T) waveform."""
        re, im = stft(x, self.n_fft, self.hop_length, self.win_length,
                      normalized=self.stft_normalized)
        hr, hi = self.init_conv(re[:, None], im[:, None])
        intermediates = [torch.cat([hr, hi], dim=1)]
        for layer in self.layers:
            hr, hi = layer(hr, hi)
            intermediates.append(torch.cat([hr, hi], dim=1))
        lr, li = self.final_conv(hr, hi)
        logits = torch.sqrt(lr * lr + li * li + 1e-6) if self.logits_abs \
            else torch.stack([lr, li], dim=-1)
        return (logits, intermediates) if return_intermediates else logits


def avg_pool1d(x, kernel: int, stride: int, padding: int):
    """torch.nn.AvgPool1d(count_include_pad=True) on (B, T)."""
    return F.avg_pool1d(x[:, None], kernel, stride, padding, count_include_pad=True)[:, 0]


class SoundStream(nn.Module):
    """Encoder (causal conv blocks, then local attention) -> grouped residual
    VQ -> decoder (local attention, then causal transposed-conv blocks), at
    `target_sample_hz`, with the GAN discriminators and the loss weights of
    training. Weights are drawn from `seed` on the CPU and moved to
    `device`; the codebooks start at zeros, uninitialised, as the JAX
    package's do under kmeans init, until training, a checkpoint or the
    caller fills them. The constructor's arguments are the JAX package's,
    less the unported ones; `config` holds them all, the unported at their
    only value, as the JAX package's checkpoints store them. With
    discriminators=False (serving) the discriminators are not built."""

    def __init__(self, *, channels: int = 32, strides=(2, 4, 5, 8),
                 channel_mults=(2, 4, 8, 16), codebook_dim: int = 512,
                 codebook_size: int = 1024, rq_num_quantizers: int = 8,
                 rq_commitment_weight: float = 1.0, rq_ema_decay: float = 0.95,
                 rq_quantize_dropout_multiple_of: int = 1, rq_groups: int = 1,
                 rq_stochastic_sample_codes: bool = False, rq_rotation_trick: bool = True,
                 rq_kwargs: "dict | None" = None, discr_multi_scales=(1, 0.5, 0.25),
                 stft_normalized: bool = False, enc_cycle_dilations=(1, 3, 9),
                 dec_cycle_dilations=(1, 3, 9),
                 multi_spectral_window_powers_of_two=tuple(range(6, 12)),
                 multi_spectral_n_ffts: int = 512, multi_spectral_n_mels: int = 64,
                 recon_loss_weight: float = 1.0,
                 multi_spectral_recon_loss_weight: float = 1e-5,
                 multi_stft_recon_loss_weight: float = 0.0,
                 multi_stft_resolutions=((128, 32, 128), (512, 128, 512), (1024, 256, 1024),
                                         (2048, 512, 2048)),
                 multi_stft_term_weights=(1.0, 1.0, 1.0), si_snr_loss_weight: float = 0.0,
                 adversarial_loss_weight: float = 1.0, feature_loss_weight: float = 100.0,
                 quantize_dropout_cutoff_index: int = 1, target_sample_hz: int = 16000,
                 use_local_attn: bool = True, attn_window_size: int = 128,
                 attn_dim_head: int = 64, attn_heads: int = 8, attn_depth: int = 1,
                 attn_xpos_scale_base: "float | None" = None,
                 attn_dynamic_pos_bias: bool = False,
                 complex_stft_discr_logits_abs: bool = True,
                 complex_stft_discr_kwargs: "dict | None" = None,
                 multi_scale_discr_kwargs: "dict | None" = None, discriminators: bool = True,
                 seed: int = 0, device: "str | torch.device" = "cuda"):
        super().__init__()
        device = resolve_device(device)
        args = {k: v for k, v in locals().items()
                if k not in ("self", "__class__", "seed", "device", "discriminators")}
        self.config = _jax_config(args)
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
        rq_kw = dict(kmeans_init=True, threshold_ema_dead_code=2.0, quantize_dropout=True)
        rq_kw.update(rq_kwargs or {})
        self.rq = GroupedResidualVQ(dim=codebook_dim, groups=rq_groups,
                                    num_quantizers=rq_num_quantizers,
                                    codebook_size=codebook_size, decay=rq_ema_decay,
                                    commitment_weight=rq_commitment_weight,
                                    quantize_dropout_multiple_of=rq_quantize_dropout_multiple_of,
                                    quantize_dropout_cutoff_index=quantize_dropout_cutoff_index,
                                    stochastic_sample_codes=rq_stochastic_sample_codes,
                                    rotation_trick=rq_rotation_trick, generator=g, **rq_kw)
        self.decoder_film = FiLM(codebook_dim, 2, generator=g)
        self.decoder_attn = LocalTransformer(**attn_kw, generator=g) if use_local_attn else None
        self.decoder_init = CausalConv1d(codebook_dim, layer_channels[-1], 7, generator=g)
        self.decoder_blocks = nn.ModuleList(
            DecoderBlock(co, ci, s, dec_cycle_dilations, generator=g)
            for (ci, co), s in zip(reversed(pairs), reversed(self.strides)))
        self.decoder_final = CausalConv1d(channels, 1, 7, generator=g)

        self.discr_multi_scales = tuple(discr_multi_scales)
        # the avg-pool factor before discriminator i + 1
        self.downsample_factors = tuple(int(a / b) for a, b in zip(self.discr_multi_scales[:-1],
                                                                  self.discr_multi_scales[1:]))
        if discriminators:
            self.discriminators = nn.ModuleList(
                MultiScaleDiscriminator(**(multi_scale_discr_kwargs or {}), generator=g)
                for _ in self.discr_multi_scales)
            self.stft_discriminator = ComplexSTFTDiscriminator(
                stft_normalized=stft_normalized, logits_abs=complex_stft_discr_logits_abs,
                **(complex_stft_discr_kwargs or {}), generator=g)
        else:
            self.discriminators = self.stft_discriminator = None
        # (n_fft, window, hop, mels, weight of the log term) a mel resolution
        self.mel_settings = tuple(
            (max(multi_spectral_n_ffts, 2 ** p), 2 ** p, 2 ** p // 4, multi_spectral_n_mels,
             (2 ** p / 2) ** 0.5) for p in multi_spectral_window_powers_of_two)
        self.stft_normalized = stft_normalized
        self.stft_loss_settings = tuple(tuple(r) for r in multi_stft_resolutions)
        self.stft_term_weights = tuple(multi_stft_term_weights)
        self.recon_loss_weight = recon_loss_weight
        self.multi_spectral_recon_loss_weight = multi_spectral_recon_loss_weight
        self.multi_stft_recon_loss_weight = multi_stft_recon_loss_weight
        self.si_snr_loss_weight = si_snr_loss_weight
        self.adversarial_loss_weight = adversarial_loss_weight
        self.feature_loss_weight = feature_loss_weight
        self.to(device)

    def non_discr_parameters(self):
        """The generator's parameters: all but the discriminators'."""
        return [p for name, p in self.named_parameters() if not name.startswith(DISCRIMINATORS)]

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

    # -- losses --------------------------------------------------------------
    def _multi_mel_loss(self, orig, recon):
        total = 0.0
        for n_fft, win, hop, n_mels, alpha in self.mel_settings:
            om, rm = (melspectrogram(w, self.target_sample_hz, n_fft, hop, win, n_mels=n_mels,
                                     normalized=self.stft_normalized) for w in (orig, recon))
            l1 = (om - rm).abs().sum(-2).mean()
            l2 = alpha * torch.linalg.vector_norm(_safe_log(om) - _safe_log(rm), dim=-2).mean()
            total = total + l1 + l2
        return total

    def _multi_stft_loss(self, orig, recon):
        """The JAX package's multi-resolution STFT loss: per resolution,
        spectral convergence, log-magnitude L1 and the L1 of the complex
        difference over the mean magnitude, weighted by stft_term_weights."""
        w_sc, w_logmag, w_phase = self.stft_term_weights
        total = 0.0
        for n_fft, hop, win in self.stft_loss_settings:
            so, sr = (torch.complex(*stft(w, n_fft, hop, win)) for w in (orig, recon))
            mo, mr = so.abs(), sr.abs()
            term = 0.0
            if w_sc:
                term = term + w_sc * torch.linalg.vector_norm(mo - mr) \
                    / (torch.linalg.vector_norm(mo) + 1e-8)
            if w_logmag:
                term = term + w_logmag * (torch.log(mo + 1e-5) - torch.log(mr + 1e-5)).abs().mean()
            if w_phase:
                term = term + w_phase * (so - sr).abs().mean() / (mo.mean() + 1e-8)
            total = total + term
        return total / len(self.stft_loss_settings)

    def _discr_logits_and_feats(self, wave):
        """All discriminators on wave: ([logits], [intermediates]), the STFT
        discriminator first."""
        logits, feats = [], []
        for i, discr in enumerate([self.stft_discriminator, *self.discriminators]):
            if i > 1:
                f = self.downsample_factors[i - 2]
                wave = avg_pool1d(wave, 2 * f, f, f)
            out, inter = discr(wave, return_intermediates=True)
            logits.append(out)
            feats.append(inter)
        return logits, feats

    def _discr_loss(self, real, fake, apply_grad_penalty: bool, separately: bool):
        """The hinge losses of the STFT discriminator and of each scale's,
        with apply_grad_penalty each one's penalty 10 (E|d loss / d real|^2 +
        E|d loss / d fake|^2), the squared norms as sums of squares (a clean
        second derivative), by autograd with create_graph. The total: the
        mean of the scales' losses, plus the STFT loss, plus the penalties;
        with separately the [(name, loss)] list instead."""

        def penalty(loss, r, f):
            gr, gf = torch.autograd.grad(loss, (r, f), create_graph=True)
            b = gr.shape[0]
            return 10.0 * (gr.reshape(b, -1).square().sum(1).mean()
                           + gf.reshape(b, -1).square().sum(1).mean())

        def leaves(r, f):
            return (r.detach().requires_grad_(apply_grad_penalty),
                    f.detach().requires_grad_(apply_grad_penalty))

        losses = []
        r, f = leaves(real, fake)
        loss = hinge_discr_loss(self.stft_discriminator(f), self.stft_discriminator(r))
        losses.append(("stft", loss))
        if apply_grad_penalty:
            losses.append(("stft_grad_penalty", penalty(loss, r, f)))
        scaled_real, scaled_fake = real, fake
        for i, (scale, discr) in enumerate(zip(self.discr_multi_scales, self.discriminators)):
            if i > 0:
                k = self.downsample_factors[i - 1]
                scaled_real = avg_pool1d(scaled_real, 2 * k, k, k)
                scaled_fake = avg_pool1d(scaled_fake, 2 * k, k, k)
            r, f = leaves(scaled_real, scaled_fake)
            loss = hinge_discr_loss(discr(f), discr(r))
            losses.append((f"scale:{scale}", loss))
            if apply_grad_penalty:
                losses.append((f"scale_grad_penalty:{scale}", penalty(loss, r, f)))
        if separately:
            return losses
        total = torch.stack([v for k, v in losses if k.startswith("scale:")]).mean()
        total = total + dict(losses)["stft"]
        for k, v in losses:
            if k.endswith("grad_penalty"):
                total = total + v
        return total

    def forward(self, x, *, train: bool = False, generator=None, target=None,
                is_denoising: "bool | None" = None, return_encoded: bool = False,
                return_codes_only: bool = False, return_discr_loss: bool = False,
                return_discr_losses_separately: bool = False,
                return_loss_breakdown: bool = False, return_recons_only: bool = False,
                input_sample_hz=None, apply_grad_penalty: bool = False):
        """The JAX forward's modes: the codes (G, B, N, Q) with
        return_codes_only; (quantized, codes (B, N, G * Q), commitment losses
        (G, Q)) with return_encoded; the reconstruction with
        return_recons_only; the discriminators' loss on x and the detached
        reconstruction with return_discr_loss (the codec's part without a
        graph); else the generator's total loss, and with
        return_loss_breakdown (total, (recon, multi-spectral mel,
        multi-resolution STFT, SI-SNR, adversarial, feature, commitment)).
        With train the quantizers train (kmeans init, EMA, dropout),
        drawing from `generator`. is_denoising (which needs a target, as in
        JAX) conditions the encoder and decoder by FiLM."""
        if is_denoising is not None and target is None:
            raise ValueError("is_denoising needs a target")
        x = self.process_input(x, input_sample_hz)
        if target is not None:
            target = self.process_input(target, input_sample_hz)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not return_discr_loss):
            h = self.encode_frames(x)
            cond = None
            if is_denoising is not None:
                cond = torch.tensor([1.0, 0.0] if is_denoising else [0.0, 1.0], device=h.device)
                h = self.encoder_film(h, cond)
            hq, indices, commit_loss = self.rq(h, train=train, generator=generator)
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
        if return_discr_loss:
            return self._discr_loss(x, recon.detach(), apply_grad_penalty,
                                    return_discr_losses_separately)

        target = (target if target is not None else x).float()
        recon32 = recon.float()
        zero = torch.zeros((), device=recon.device)
        recon_loss = (target - recon32).square().mean()
        mel_loss = self._multi_mel_loss(target, recon32) \
            if self.multi_spectral_recon_loss_weight > 0 else zero
        stft_loss = self._multi_stft_loss(target, recon32) \
            if self.multi_stft_recon_loss_weight > 0 else zero
        b = target.shape[0]
        si_snr_loss = -si_snr(recon32.reshape(b, -1), target.reshape(b, -1)).mean() \
            if self.si_snr_loss_weight > 0 else zero
        if self.adversarial_loss_weight == 0 and self.feature_loss_weight == 0:
            # the reconstruction phase: the discriminators do not run
            adversarial_loss = feature_loss = zero
        else:
            logits, fake_feats = self._discr_logits_and_feats(recon)
            _, real_feats = self._discr_logits_and_feats(x.detach())
            adversarial_loss = torch.stack([hinge_gen_loss(lg) for lg in logits]).mean()
            feature_loss = torch.stack([(r.float() - f.float()).abs().mean()
                                        for rf, ff in zip(real_feats, fake_feats)
                                        for r, f in zip(rf, ff)]).mean()
        all_commit = commit_loss.sum()
        total = (recon_loss * self.recon_loss_weight
                 + mel_loss * self.multi_spectral_recon_loss_weight
                 + stft_loss * self.multi_stft_recon_loss_weight
                 + si_snr_loss * self.si_snr_loss_weight
                 + adversarial_loss * self.adversarial_loss_weight
                 + feature_loss * self.feature_loss_weight
                 + all_commit)
        if return_loss_breakdown:
            return total, (recon_loss, mel_loss, stft_loss, si_snr_loss, adversarial_loss,
                           feature_loss, all_commit)
        return total


def AudioLMSoundStream(strides=(2, 4, 5, 8), target_sample_hz=16000, rq_num_quantizers=12,
                       **kwargs):
    """The AudioLM preset of the JAX package: 16 kHz, 50 frames a second,
    12 quantizers."""
    return SoundStream(strides=strides, target_sample_hz=target_sample_hz,
                       rq_num_quantizers=rq_num_quantizers, **kwargs)


# what the port does not have: the JAX package's config keys and the only
# value each may take here
_UNPORTED = {"use_lookup_free_quantizer": False, "use_finite_scalar_quantizer": False,
             "finite_scalar_quantizer_levels": None, "squeeze_excite": False,
             "use_gate_loop_layers": False, "input_channels": 1, "compute_dtype": "float32",
             "pad_mode": "reflect"}
# rq_kwargs the port's quantizers take
_RQ_KWARGS = ("kmeans_init", "threshold_ema_dead_code", "quantize_dropout")


def _jax_config(args: dict) -> dict:
    """The JAX package's config dict (`SoundStream.configs`) of the port's
    constructor arguments: tuples as lists (JSON), the kwargs dicts never
    None, the unported keys at their values."""
    def plain(v):
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v

    cfg = {k: plain(v) for k, v in args.items()}
    for key in ("rq_kwargs", "complex_stft_discr_kwargs", "multi_scale_discr_kwargs"):
        cfg[key] = cfg[key] or {}
    cfg.update(_UNPORTED)
    return dict(sorted(cfg.items()))


def load_soundstream(path, *, device: "str | torch.device" = "cuda",
                     discriminators: bool = True):
    """A SoundStream from a JAX `.npz` checkpoint (`SoundStream.save`, a
    persisted trainer checkpoint with its config, or a trainer checkpoint
    of the port's), in float32, with its quantizers' training state. Every
    config key is a constructor argument or an unported feature at its only
    value (`_UNPORTED`; `rq_kwargs` may hold only `_RQ_KWARGS`); anything
    else raises. For serving, discriminators=False neither builds the
    discriminators nor reads their weights. A trainer checkpoint's model is
    the leaves under `['model']`."""
    device = resolve_device(device)
    meta, arrays = read_npz(path)
    if any(name.startswith("['model']") for name in arrays):
        arrays = {name[len("['model']"):]: a for name, a in arrays.items()
                  if name.startswith("['model']")}
    cfg = dict(meta["config"])
    for key, value in _UNPORTED.items():
        if cfg.pop(key, value) != value:
            raise NotImplementedError(f"{path}: {key}={meta['config'][key]!r} is not ported")
    extra = sorted(set(cfg.get("rq_kwargs") or {}) - set(_RQ_KWARGS))
    if extra:
        raise NotImplementedError(f"{path}: rq_kwargs {extra} are not honoured by the port")
    unknown = sorted(set(cfg) - set(inspect.signature(SoundStream).parameters)
                     - {"seed", "device", "discriminators"})
    if unknown:
        raise NotImplementedError(f"{path}: config keys {unknown} are not honoured by the port")
    model = SoundStream(**cfg, discriminators=discriminators, device="cpu")
    state = codec_state_dict_from_jax(arrays)
    if not discriminators:
        state = {k: v for k, v in state.items() if not k.startswith(DISCRIMINATORS)}
    model.load_state_dict(state)
    return model.to(device)
