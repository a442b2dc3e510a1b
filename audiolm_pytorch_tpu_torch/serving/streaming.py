"""Chunked (streaming) codec encode and decode for serving, held against the
JAX package's `serving/streaming.py`: mic in -> codes with
`StreamingCodecEncoder`, codes -> speaker out with `StreamingCodecDecoder`,
each holding a bounded buffer and giving, chunk by chunk, the same codes
and samples as one offline `tokenize` or `decode_from_codebook_indices` of
the whole signal.

The codec is causal end to end (causal convolutions and transposed
convolutions, local attention over a window and the one before it), so the
output of frames [a, b) needs only a bounded past: `decode_lookback_frames`
and `encode_lookback` walk the module chain and add up each stage's causal
reach. Kernel sizes are read from the port's modules (`kernel_size`), not
from a weight's shape, whose layout differs from JAX's. A window's start is
aligned to the attention window, so the local attention buckets frames as
the offline pass does.

A codec with squeeze-excite or GateLoop layers reaches back to the start
of the signal: both lookbacks are -1 there and both classes raise, as
JAX's do. The quantizer is whichever the codec has (VQ, LFQ or FSQ): each
codes a frame from that frame's embedding alone.

Each chunk runs eagerly on the codec's device: the encoder's conv stack,
K7 in `encoder_attn` and K6 in each residual search (a VQ codec's); the decoder's
`decode_from_codebook_indices`, with K7 in `decoder_attn`. Input and output
cross the boundary as numpy arrays, as in JAX: codes as int32 (G, B, m, Q),
waveforms as float32 (B, m * DS).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..models.soundstream import DecoderBlock, EncoderBlock, SoundStream

__all__ = ["StreamingCodecDecoder", "StreamingCodecEncoder", "decode_lookback_frames",
           "encode_lookback"]


def _unbounded_unit(res) -> bool:
    """A residual unit whose reach is the whole past: one with
    squeeze-excite, whose gate reads the causal mean of every frame so
    far."""
    return res.se is not None


def _check_mono(codec: SoundStream):
    if codec.input_channels != 1:
        raise ValueError("streaming a codec of more than one input channel is not ported: "
                         "tokenize or decode the whole signal")


def decode_lookback_frames(codec: SoundStream) -> int:
    """Causal lookback of the decode path, in code frames, or -1 where it is
    unbounded (GateLoop blocks, squeeze-excite). Walking the chain backwards
    at each stage's rate: a causal conv (k, d) needs (k - 1) d past samples;
    a causal transposed conv (k, stride s) turns a need of n output samples
    into ceil((n + k - 1) / s) input samples; a local attention layer of
    window w reaches 2w frames back."""
    need = codec.decoder_final.kernel_size - 1  # the sample rate
    for block in reversed(codec.decoder_blocks):
        if not isinstance(block, DecoderBlock):
            return -1
        for res in (block.res3, block.res2, block.res1):
            need += (res.conv1.kernel_size - 1) * res.conv1.dilation
            need += res.conv2.kernel_size - 1
            if _unbounded_unit(res):
                return -1
        need = math.ceil((need + block.up.kernel_size - 1) / block.up.stride)
    need += codec.decoder_init.kernel_size - 1  # the frame rate
    if codec.decoder_attn is not None:
        need += 2 * codec.decoder_attn.window_size * len(codec.decoder_attn.layers)
    return int(need)


def encode_lookback(codec: SoundStream) -> tuple:
    """Causal lookback of the encode path, (conv_samples, attn_frames): the
    raw samples the conv stack needs for a frame's pre-attention embedding
    to be exact, and the frames the bottleneck's local attention reaches
    back (2w a layer); (-1, -1) where it is unbounded."""
    need = codec.encoder_final.kernel_size - 1  # the frame rate
    for block in reversed(codec.encoder_blocks):
        if not isinstance(block, EncoderBlock):
            return -1, -1
        need = need * block.down.stride + (block.down.kernel_size - 1)
        for res in (block.res3, block.res2, block.res1):
            if _unbounded_unit(res):
                return -1, -1
            need += (res.conv1.kernel_size - 1) * res.conv1.dilation
            need += res.conv2.kernel_size - 1
    need += codec.encoder_init.kernel_size - 1  # the sample rate
    attn = (2 * codec.encoder_attn.window_size * len(codec.encoder_attn.layers)
            if codec.encoder_attn is not None else 0)
    return int(need), int(attn)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _device(codec: SoundStream) -> torch.device:
    return next(codec.parameters()).device


class StreamingCodecEncoder:
    """Stateful chunked tokenizer over raw samples.

    >>> enc = StreamingCodecEncoder(codec, chunk_frames=16)
    >>> for samples in wave_stream:          # (B, n) or (n,), any n
    ...     codes = enc.push(samples)        # (G, B, m, Q) int32, newly ready
    >>> codes = enc.flush()                  # the remaining whole frames

    The codes equal `codec.tokenize(whole_wave)`'s for the same frames. The
    buffer keeps `encode_lookback` samples of raw audio (the conv stack's
    reach, rounded up to whole frames) and the attention's context, aligned
    to its window; the frames the window's edge spoils are cut before the
    attention, so they never become its keys. A chunk is rounded up to the
    attention window. Samples short of a whole frame are dropped at flush,
    as the offline pass curtails them.
    """

    def __init__(self, codec: SoundStream, *, chunk_frames: int = 16):
        _check_mono(codec)
        self.codec = codec
        self.device = _device(codec)
        self.ds = codec.seq_len_multiple_of
        conv_lb, attn_lb = encode_lookback(codec)
        if conv_lb < 0:
            raise ValueError("the codec's encode path has unbounded lookback (GateLoop or "
                             "squeeze-excite); streaming encode is unavailable: tokenize the "
                             "whole waveform")
        align = codec.encoder_attn.window_size if codec.encoder_attn is not None else 1
        self.align = align
        self.context = int(math.ceil(attn_lb / align) * align)
        self.pad_frames = int(math.ceil(conv_lb / self.ds))
        # every steady-state window has one length: pad + context + chunk
        self.chunk = int(math.ceil(chunk_frames / align) * align)
        self._wave = None  # (B, n) float32, the recent raw samples
        self._base = 0     # the absolute frame of self._wave[:, 0]
        self._emitted = 0  # frames emitted so far

    @property
    def buffered_frames(self) -> int:
        """Whole frames pushed so far (an absolute count)."""
        if self._wave is None:
            return self._base
        return self._base + self._wave.shape[1] // self.ds

    @torch.no_grad()
    def _window_codes(self, x: torch.Tensor, trim: int) -> torch.Tensor:
        codec = self.codec
        h = codec.encoder_init(x.to(codec.compute_dtype)[..., None])
        for block in codec.encoder_blocks:
            h = block(h)
        h = codec.encoder_final(h)[:, trim:]  # drop the frames the window's edge spoils
        if codec.encoder_attn is not None:
            h = codec.encoder_attn(h)
        _, indices, _ = codec.rq(h, train=False)
        return indices

    def push(self, samples) -> np.ndarray:
        """Append raw samples, (B, n) or (n,); return the newly ready codes
        (G, B, m, Q), whole chunks only."""
        samples = _numpy(samples).astype(np.float32, copy=False)
        if samples.ndim == 1:
            samples = samples[None]
        self._wave = samples if self._wave is None else \
            np.concatenate([self._wave, samples], axis=1)
        return self._emit((self.buffered_frames // self.chunk) * self.chunk)

    def flush(self) -> np.ndarray:
        """The codes of every remaining whole frame."""
        return self._emit(self.buffered_frames)

    def _emit(self, upto: int) -> np.ndarray:
        if upto <= self._emitted:
            b = 1 if self._wave is None else self._wave.shape[0]
            return np.zeros((self.codec.rq_groups, b, 0, self.codec.num_quantizers), np.int32)
        outs = []
        while self._emitted < upto:
            outs.append(self._emit_one(min(self._emitted + self.chunk, upto)))
        return np.concatenate(outs, axis=2)

    def _emit_one(self, upto: int) -> np.ndarray:
        start = max(0, self._emitted - self.context)
        start = (start // self.align) * self.align  # the attention's bucket
        conv_start = max(0, start - self.pad_frames)
        window = self._wave[:, (conv_start - self._base) * self.ds:(upto - self._base) * self.ds]
        idx = self._window_codes(torch.from_numpy(np.ascontiguousarray(window)).to(self.device),
                                 start - conv_start)
        out = idx[:, :, self._emitted - start:].cpu().numpy().astype(np.int32)
        self._emitted = upto
        # drop the samples no later window reaches
        keep_from = max(0, (max(0, self._emitted - self.context) // self.align) * self.align
                        - self.pad_frames)
        if keep_from > self._base:
            self._wave = self._wave[:, (keep_from - self._base) * self.ds:]
            self._base = keep_from
        return out


class StreamingCodecDecoder:
    """Stateful chunked decoder over code frames.

    >>> dec = StreamingCodecDecoder(codec, chunk_frames=16)
    >>> for codes in code_stream:           # (G, B, n, Q) or flat (B, n, G * Q)
    ...     audio = dec.push(codes)         # (B, m * DS) float32, newly decoded
    >>> audio = dec.flush()                 # the rest

    The samples are the matching slice of
    `codec.decode_from_codebook_indices(all_codes)`: each chunk is decoded
    with `decode_lookback_frames` of context before it, its start aligned to
    the decoder's attention window, and the buffer is trimmed to what later
    chunks can reach.
    """

    def __init__(self, codec: SoundStream, *, chunk_frames: int = 16):
        _check_mono(codec)
        self.codec = codec
        self.device = _device(codec)
        self.ds = codec.seq_len_multiple_of
        lb = decode_lookback_frames(codec)
        if lb < 0:
            raise ValueError("the codec's decode path has unbounded lookback (GateLoop or "
                             "squeeze-excite); streaming decode is unavailable: decode the "
                             "whole sequence with decode_from_codebook_indices")
        align = codec.decoder_attn.window_size if codec.decoder_attn is not None else 1
        self.context = int(math.ceil(lb / align) * align)
        self.align = align
        self.chunk = chunk_frames
        self._codes = None  # (G, B, n, Q), the recent frames
        self._base = 0      # the absolute frame of self._codes[:, :, 0]
        self._emitted = 0   # frames emitted so far

    @property
    def buffered_frames(self) -> int:
        """Frames pushed so far (an absolute count)."""
        return self._base + (0 if self._codes is None else self._codes.shape[2])

    def _append(self, codes):
        codes = _numpy(codes)
        if codes.ndim == 3:  # flat (B, n, G * Q)
            b, n, gq = codes.shape
            g = self.codec.rq_groups
            codes = codes.reshape(b, n, g, gq // g).transpose(2, 0, 1, 3)
        if codes.ndim != 4:
            raise ValueError(f"codes must be (G, B, n, Q) or (B, n, G * Q), not {codes.shape}")
        self._codes = codes if self._codes is None else \
            np.concatenate([self._codes, codes], axis=2)

    @torch.no_grad()
    def _emit(self, upto: int) -> np.ndarray:
        """The samples of frames [emitted, upto)."""
        if upto <= self._emitted:
            b = 1 if self._codes is None else self._codes.shape[1]
            return np.zeros((b, 0), np.float32)
        start = max(0, self._emitted - self.context)
        start = (start // self.align) * self.align  # the attention's bucket
        window = self._codes[:, :, start - self._base:upto - self._base]
        wave = self.codec.decode_from_codebook_indices(
            torch.from_numpy(np.ascontiguousarray(window)).to(self.device, torch.long))
        out = wave[:, (self._emitted - start) * self.ds:(upto - start) * self.ds]
        out = out.float().cpu().numpy()
        self._emitted = upto
        # drop the frames no later window reaches: O(context + chunk) held
        keep_from = (max(0, self._emitted - self.context) // self.align) * self.align
        if keep_from > self._base:
            self._codes = self._codes[:, :, keep_from - self._base:]
            self._base = keep_from
        return out

    def push(self, codes) -> np.ndarray:
        """Append code frames; return the newly ready samples (B, m * DS),
        whole chunks only."""
        self._append(codes)
        return self._emit((self.buffered_frames // self.chunk) * self.chunk)

    def flush(self) -> np.ndarray:
        """Decode every remaining frame (possibly a short tail)."""
        return self._emit(self.buffered_frames)
