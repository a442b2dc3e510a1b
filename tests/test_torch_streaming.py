"""The port's streaming codec serving (`serving/streaming.py`) against the
JAX package's on the CPU.

The lookbacks (`decode_lookback_frames`, `encode_lookback`) equal JAX's on
tiny codecs with and without local attention, with other strides and
dilations, and on persist/soundstream_r5_73k.npz's config (149 frames and
(5313 samples, 128 frames)): JAX reads a kernel size from a weight's
leading axis, the port from its modules, whose weights are laid out
otherwise. The streamed waveform equals JAX's `StreamingCodecDecoder`'s on
the same codes within JAX's own tolerance (rtol 1e-4, atol 1e-5,
tests/test_streaming.py) and the port's offline decode; the streamed codes
equal JAX's `StreamingCodecEncoder`'s and the port's offline `tokenize`,
int32 in JAX's (G, B, m, Q) layout. Irregular pushes, the flat code layout,
an empty push and the bounded buffers are covered on the port alone.

JAX's quantizer takes the Pallas nearest-code kernel (K6) in interpret
mode, as in tests/test_torch_codec.py (`pallas_vq`), so both sides pick
codes by K6's formula. The tiny codecs' weights are random, built by
shape (`jax.eval_shape`) and copied across by key path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models.soundstream import SoundStream as JSoundStream
from audiolm_pytorch_tpu.serving import streaming as jstream
from audiolm_pytorch_tpu.training.checkpoint import load_checkpoint

from audiolm_pytorch_tpu_torch import (SoundStream, StreamingCodecDecoder,
                                       StreamingCodecEncoder, decode_lookback_frames,
                                       encode_lookback, load_soundstream)
from audiolm_pytorch_tpu_torch.weights import codec_state_dict_from_jax

from tests.test_soundstream import tiny_soundstream
from tests.test_torch_codec import CKPT, TINY, _random_weights, pallas_vq  # noqa: F401
from torch_port_util import jax_replace, t

# the tiny codec's variants: without attention; and other strides, cycle
# dilations and attention depth, so a kernel size read from the wrong axis
# of a weight shows
VARIANTS = {"attn": {}, "no_attn": dict(use_local_attn=False, attn_window_size=16),
            "strides": dict(strides=(4, 2), enc_cycle_dilations=(1, 2, 5),
                            dec_cycle_dilations=(2, 3, 4), attn_depth=2, channel_mults=(3, 5))}
WAVE_TOL = dict(rtol=1e-4, atol=1e-5)  # JAX's tests/test_streaming.py


def tiny_pair(variant, seed=0):
    """A tiny JAX codec with random weights, its first codebook drawn from
    its encoder's frames and the rest at about the size of the residuals,
    and the port's copy."""
    kw = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    jkw = dict(kw, attn_window_size=None) if variant == "no_attn" else kw
    shapes = jax.eval_shape(lambda: tiny_soundstream(key=jax.random.PRNGKey(seed), **jkw))
    new = _random_weights(shapes, rng)
    pm = SoundStream(**dict(TINY, **kw), discriminators=True, device="cpu").eval()
    pm.load_state_dict(codec_state_dict_from_jax(new))
    with torch.no_grad():
        h = pm.encode_frames(t(signal(64, pm.seq_len_multiple_of, seed))).numpy()
    h = h.reshape(-1, h.shape[-1])
    for name, a in new.items():
        if name.endswith("codebook[<flat index 0>]"):
            q = int(name.split(".layers[")[1].split("]")[0])
            noise = h.std() * 0.5 ** q * rng.normal(size=a.shape)
            new[name] = (noise + (h[rng.choice(len(h), a.shape[0])] if q == 0 else 0)
                         ).astype(np.float32)
    pm.load_state_dict(codec_state_dict_from_jax(new))
    return jax_replace(shapes, new), pm


@pytest.fixture(scope="module")
def pairs():
    return {v: tiny_pair(v) for v in ("attn", "no_attn")}


def signal(n_frames, ds, seed=0, b=2):
    return (0.3 * np.random.default_rng(seed).normal(size=(b, n_frames * ds))).astype(np.float32)


def stream(enc_or_dec, pieces):
    outs = [enc_or_dec.push(p) for p in pieces]
    outs.append(enc_or_dec.flush())
    return outs


@pytest.mark.parametrize("variant", list(VARIANTS) + ["persisted"])
def test_lookbacks_equal_jax(variant):
    if variant == "persisted":
        cfg = load_checkpoint(str(CKPT))["config"]
        jm = jax.eval_shape(lambda: JSoundStream(**cfg, key=jax.random.PRNGKey(0)))
        pm = load_soundstream(CKPT, device="cpu", discriminators=False)
        assert decode_lookback_frames(pm) == 149
        assert encode_lookback(pm) == (5313, 128)
    else:
        kw = VARIANTS[variant]
        jkw = dict(kw, attn_window_size=None) if variant == "no_attn" else kw
        jm = jax.eval_shape(lambda: tiny_soundstream(**jkw))
        pm = SoundStream(**dict(TINY, **kw), discriminators=False, device="cpu")
    assert decode_lookback_frames(pm) == jstream.decode_lookback_frames(jm) > 0
    assert encode_lookback(pm) == tuple(jstream.encode_lookback(jm))


@pytest.mark.parametrize("variant", ["attn", "no_attn"])
def test_streaming_decoder_matches_jax_and_offline(pairs, variant):
    jm, pm = pairs[variant]
    with torch.no_grad():
        # 128 frames: past the decoder's 80-frame context, later windows start
        # at a shifted, aligned frame
        codes = pm.tokenize(t(signal(128, pm.seq_len_multiple_of, seed=1))).numpy()
        offline = pm.decode_from_codebook_indices(t(codes)).numpy()
    bites = [codes[:, :, i:i + 5] for i in range(0, codes.shape[2], 5)]
    got = np.concatenate(stream(StreamingCodecDecoder(pm, chunk_frames=16), bites), -1)
    jdec = jstream.StreamingCodecDecoder(jm, chunk_frames=16)
    want = np.concatenate(stream(jdec, bites), -1)
    assert got.dtype == np.float32 and got.shape == offline.shape == want.shape
    np.testing.assert_allclose(got, want, **WAVE_TOL)
    np.testing.assert_allclose(got, offline, **WAVE_TOL)


@pytest.mark.parametrize("variant", ["attn", "no_attn"])
def test_streaming_encoder_matches_jax_and_tokenize(pallas_vq, pairs, variant):
    jm, pm = pairs[variant]
    ds = pm.seq_len_multiple_of
    # 96 frames: later windows start past the 35 pad frames of the conv reach
    x = signal(96, ds, seed=2)
    x = np.concatenate([x, x[:, :ds - 3]], 1)  # a tail short of a whole frame
    step = 5 * ds + 3  # bites not aligned to frames
    pieces = [x[:, i:i + step] for i in range(0, x.shape[1], step)]
    got = np.concatenate(stream(StreamingCodecEncoder(pm, chunk_frames=16), pieces), 2)
    want = np.concatenate(stream(jstream.StreamingCodecEncoder(jm, chunk_frames=16), pieces), 2)
    with torch.no_grad():
        offline = pm.tokenize(t(x)).numpy()
    assert got.dtype == np.int32 and got.shape == offline.shape == (1, 2, 96, 4)
    assert len(np.unique(got[0, :, :, 0])) > 4  # the codebooks are in use
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, offline)


def test_flat_layout_empty_push_and_bounded_buffers(pairs):
    _, pm = pairs["attn"]
    ds = pm.seq_len_multiple_of
    x = signal(200, ds, seed=3, b=1)
    with torch.no_grad():
        codes = pm.tokenize(t(x)).numpy()
        offline = pm.decode_from_codebook_indices(t(codes)).numpy()
    g, b, n, q = codes.shape
    flat = codes.transpose(1, 2, 0, 3).reshape(b, n, g * q)

    dec = StreamingCodecDecoder(pm, chunk_frames=256)  # longer than the stream
    assert dec.push(flat[:, :0]).shape == (1, 0) and dec.push(flat).shape == (1, 0)
    np.testing.assert_allclose(dec.flush(), offline, **WAVE_TOL)

    dec = StreamingCodecDecoder(pm, chunk_frames=16)
    outs = []
    for i in range(0, n, 5):
        outs.append(dec.push(flat[:, i:i + 5]))
        assert dec._codes.shape[2] <= dec.context + dec.chunk + 5 + dec.align
    outs.append(dec.flush())
    assert dec.buffered_frames == n
    np.testing.assert_allclose(np.concatenate(outs, -1), offline, **WAVE_TOL)

    enc = StreamingCodecEncoder(pm, chunk_frames=8)
    empty = enc.push(x[0, :ds - 1])  # a 1-D push short of a frame
    assert empty.shape == (1, 1, 0, 4) and empty.dtype == np.int32
    outs = [empty]
    step = 7 * ds + 5
    for i in range(ds - 1, x.shape[1], step):
        outs.append(enc.push(x[:, i:i + step]))
        held = enc._wave.shape[1] // ds
        assert held <= enc.pad_frames + enc.context + enc.chunk + step // ds + 1 + enc.align
    outs.append(enc.flush())
    np.testing.assert_array_equal(np.concatenate(outs, 2), codes)


def test_a_first_chunk_inside_the_reflect_pad_follows_jax(pallas_vq, pairs):
    """Recorded divergence, shared with JAX: the causal convolutions' left
    pad reflects the first samples, so at a stream's start the offline
    encode and decode read frames ahead. A first chunk shorter than that
    reach (8 frames here; 16 reach past it) cannot match the offline pass,
    in JAX as in the port; the port still gives JAX's streamed samples and
    codes."""
    jm, pm = pairs["attn"]
    with torch.no_grad():
        codes = pm.tokenize(t(signal(24, pm.seq_len_multiple_of, seed=3, b=1))).numpy()
        offline = pm.decode_from_codebook_indices(t(codes)).numpy()
    bites = [codes[:, :, i:i + 5] for i in range(0, codes.shape[2], 5)]
    got = np.concatenate(stream(StreamingCodecDecoder(pm, chunk_frames=8), bites), -1)
    want = np.concatenate(stream(jstream.StreamingCodecDecoder(jm, chunk_frames=8), bites), -1)
    np.testing.assert_allclose(got, want, **WAVE_TOL)
    first = 8 * pm.seq_len_multiple_of
    assert np.abs(got[:, :first] - offline[:, :first]).max() > 1e-3
    np.testing.assert_allclose(got[:, 2 * first:], offline[:, 2 * first:], **WAVE_TOL)

    jm, pm = pairs["no_attn"]  # no attention window to round the chunk up to
    x = signal(24, pm.seq_len_multiple_of, seed=2)
    pieces = [x[:, i:i + 43] for i in range(0, x.shape[1], 43)]
    got = np.concatenate(stream(StreamingCodecEncoder(pm, chunk_frames=8), pieces), 2)
    want = np.concatenate(stream(jstream.StreamingCodecEncoder(jm, chunk_frames=8), pieces), 2)
    with torch.no_grad():
        offline = pm.tokenize(t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[:, :, :8] != offline[:, :, :8]).any()
    np.testing.assert_array_equal(got[:, :, 16:], offline[:, :, 16:])
