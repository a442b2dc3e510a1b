"""The port's SoundStream codec at serving time against the JAX package on
the CPU: the causal convolutions (strides, dilations, a reflect pad as long
as the input or longer); a tiny codec (tests/test_soundstream.py's sizes)
with random non-zero codebooks, in 1 and 2 groups: encode_frames, tokenize,
return_encoded, is_denoising, decode_from_codebook_indices in both layouts,
and decodes of 1-6 frames; the persisted trained codec
persist/soundstream_r5_73k.npz through `load_soundstream` on four held-out
clips of bench.py's `bench_codec_quality` corpus: codes identical, the
reconstruction close, per-clip SI-SNR within 0.01 dB; and the loader's
refusal of a config key it does not honour.

JAX's quantizer takes its TPU path here, the Pallas nearest-code kernel
(K6) in interpret mode: the test patches `audiolm_pytorch_tpu.ops.pallas.
on_tpu` and the kernel's interpret flag, and leaves the JAX package as it
is. JAX's CPU path (`argmin` of the squared distance, with |x|^2 added)
can differ from K6's formula on near-ties; the persisted-codec test counts
those differences and prints them.

Tolerances: 1e-5 absolute on the convolutions; the tiny codec 1e-4 (float32
through some twenty layers, summation order only); the trained codec's
reconstruction 1e-3 of the clip's peak (a deeper, wider stack of float32
convolutions); SI-SNR 0.01 dB."""
import functools
import json
import random
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models.soundstream import SoundStream as JSoundStream
from audiolm_pytorch_tpu.ops import conv as jconv
from audiolm_pytorch_tpu.ops import pallas as jpallas
from audiolm_pytorch_tpu.ops.pallas import vq as jvq
from audiolm_pytorch_tpu.training.checkpoint import load_checkpoint
from audiolm_pytorch_tpu.utils.metrics import si_snr as j_si_snr

from audiolm_pytorch_tpu_torch import SoundStream, load_soundstream, si_snr
from audiolm_pytorch_tpu_torch.ops import conv as pconv
from audiolm_pytorch_tpu_torch.weights import codec_state_dict_from_jax

from tests.test_soundstream import tiny_soundstream
from torch_port_util import jax_replace, t

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "persist" / "soundstream_r5_73k.npz"
# the tiny codec's sizes (tests/test_soundstream.py), the port's arguments,
# its discriminators and spectral losses included
TINY = dict(channels=8, strides=(2, 4), channel_mults=(2, 4), codebook_dim=32,
            codebook_size=64, rq_num_quantizers=4, attn_window_size=16, attn_heads=2,
            attn_dim_head=16, multi_spectral_window_powers_of_two=(6, 7),
            multi_spectral_n_ffts=128, multi_spectral_n_mels=32,
            multi_scale_discr_kwargs=dict(channels=4, layers=2, groups=(1, 2), chan_max=32),
            complex_stft_discr_kwargs=dict(channels=4, n_fft=128, hop_length=32,
                                           win_length=128, strides=((1, 2), (2, 2)),
                                           chan_mults=(1, 2)))


@pytest.fixture
def pallas_vq(monkeypatch):
    """JAX's quantizer on its TPU path: K6, here in interpret mode."""
    monkeypatch.setattr(jpallas, "on_tpu", lambda: True)
    monkeypatch.setattr(jvq, "vq_nearest_code",
                        functools.partial(jvq.vq_nearest_code, interpret=True))


@pytest.mark.parametrize("k,stride,dilation,n", [(7, 1, 1, 40), (7, 1, 9, 40), (7, 1, 9, 5),
                                                 (3, 1, 1, 1), (8, 4, 1, 12), (4, 2, 1, 3),
                                                 (16, 8, 1, 8)])
def test_causal_conv1d_matches_jax(k, stride, dilation, n):
    rng = np.random.default_rng(k + stride + dilation + n)
    x = rng.normal(size=(2, n, 3)).astype(np.float32)
    w = rng.normal(size=(k, 3, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    want = jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                               dilation=dilation)
    got = pconv.causal_conv1d(t(x), t(w).permute(2, 1, 0), t(b), stride=stride,
                              dilation=dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_reflect_pad_follows_numpy():
    """Pads as long as the input or longer reflect again and again."""
    for n, pad in ((3, 5), (1, 4), (6, 54), (55, 54)):
        x = np.arange(n, dtype=np.float32)
        got = pconv.reflect_pad_left(t(x)[None, :, None], pad)[0, :, 0].numpy()
        np.testing.assert_array_equal(got, np.pad(x, (pad, 0), mode="reflect")
                                      if n > 1 else np.full(n + pad, x[0]))
        np.testing.assert_array_equal(got, np.asarray(jnp.pad(jnp.asarray(x), (pad, 0),
                                                               mode="reflect")))


@pytest.mark.parametrize("k,stride,n", [(4, 2, 5), (10, 5, 3), (16, 8, 1)])
def test_causal_conv_transpose1d_matches_jax(k, stride, n):
    rng = np.random.default_rng(k + n)
    x = rng.normal(size=(2, n, 4)).astype(np.float32)
    w = rng.normal(size=(k, 4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    want = jconv.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                         stride=stride)
    got = pconv.causal_conv_transpose1d(t(x), t(w).permute(1, 2, 0), t(b), stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _random_weights(shapes, rng):
    """{key path: numpy array} for every leaf of a JAX module's shape tree:
    weights uniform within 1/sqrt(fan-in), nonzero biases, norm gains and
    qk scales around 1, empty EMA statistics (the codebooks are set apart)."""
    new = {}
    for path, a in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = jax.tree_util.keystr(path)
        leaf = name.split("[<flat")[0].rsplit(".", 1)[-1]
        if leaf in ("gamma", "q_scale", "k_scale"):
            v = rng.uniform(0.5, 1.5, size=a.shape)
        elif leaf == "weight":
            lim = 1 / np.sqrt(np.prod(a.shape[:-1]))
            v = rng.uniform(-lim, lim, size=a.shape)
        elif leaf == "bias":
            v = 0.1 * rng.normal(size=a.shape)
        elif leaf == "initted":
            v = np.ones(a.shape, bool)
        else:
            v = np.zeros(a.shape)
        new[name] = v.astype(a.dtype)
    return new


def _tiny_pair(groups, seed=0):
    """The tiny JAX codec with random weights and random codebooks at about
    the size of its residuals, and the port's copy of it. The JAX module is
    built from its shapes (`jax.eval_shape`): built op by op, its random
    initialisation compiles for tens of seconds."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: tiny_soundstream(key=jax.random.PRNGKey(seed),
                                                     rq_groups=groups))
    new = _random_weights(shapes, rng)
    pm = SoundStream(**TINY, rq_groups=groups, device="cpu").eval()
    pm.load_state_dict(codec_state_dict_from_jax(new))
    with torch.no_grad():
        h = pm.encode_frames(t(rng.normal(size=(2, 512)).astype(np.float32))).numpy()
    for name, a in new.items():
        if name.endswith("codebook[<flat index 0>]"):
            q = int(name.split(".layers[")[1].split("]")[0])
            new[name] = (h.std() * 0.5 ** q * rng.normal(size=a.shape)).astype(np.float32)
    pm.load_state_dict(codec_state_dict_from_jax(new))
    return jax_replace(shapes, new), pm


TINY_TOL = dict(rtol=1e-4, atol=1e-4)


def _jit(fn):
    """fn(model, *arrays) compiled once per shape: op-by-op JAX compiles
    each of the codec's ops for each new shape, several times slower."""
    return jax.jit(fn)


def _jax_serving(m, a):
    """The JAX codec's serving outputs of one input, compiled as one program."""
    codes = m.tokenize(a)
    return dict(frames=m.encode_frames(m.process_input(a)), codes=codes,
                encoded=m(a, return_encoded=True),
                denoised=[m(a, target=a, is_denoising=d, return_recons_only=True)
                          for d in (True, False)],
                wave=m.decode_from_codebook_indices(codes))


@pytest.mark.parametrize("groups", [1, 2])
def test_tiny_codec_matches_jax(pallas_vq, groups):
    jm, pm = _tiny_pair(groups)
    x = np.random.default_rng(3).normal(size=(2, 1030)).astype(np.float32) * 0.5
    want = _jit(_jax_serving)(jm, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(pm.encode_frames(pm.process_input(t(x))).numpy(),
                                   np.asarray(want["frames"]), **TINY_TOL)
        codes = pm.tokenize(t(x))
        jcodes = np.asarray(want["codes"])
        assert codes.shape == (groups, 2, 128, 4)
        assert len(np.unique(jcodes[0, :, :, 0])) > 8  # the codebooks are in use
        np.testing.assert_array_equal(codes.numpy(), jcodes)
        hq, flat, commit = pm(t(x), return_encoded=True)
        jhq, jflat, jcommit = want["encoded"]
        np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
        np.testing.assert_allclose(hq.numpy(), np.asarray(jhq), **TINY_TOL)
        np.testing.assert_allclose(commit.numpy(), np.asarray(jcommit), **TINY_TOL)
        for denoise, jrecon in zip((True, False), want["denoised"]):
            got = pm(t(x), target=t(x), is_denoising=denoise, return_recons_only=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(jrecon), **TINY_TOL)
        wave = pm.decode_from_codebook_indices(codes)
        np.testing.assert_allclose(wave.numpy(), np.asarray(want["wave"]), **TINY_TOL)
        np.testing.assert_allclose(pm.decode_from_codebook_indices(flat).numpy(), wave.numpy(),
                                   rtol=0, atol=0)
        # short decodes: the causal convs' reflect pad runs past the input
        jdecode = _jit(lambda m, c: m.decode_from_codebook_indices(c))
        for n in range(1, 7):
            got = pm.decode_from_codebook_indices(flat[:1, :n]).numpy()
            want_n = np.asarray(jdecode(jm, jnp.asarray(flat.numpy()[:1, :n])))
            assert got.shape == (1, n * 8)
            np.testing.assert_allclose(got, want_n, **TINY_TOL)
    # no mode: the generator's training loss (held to JAX's in
    # tests/test_torch_codec_train.py)
    with torch.no_grad():
        assert torch.isfinite(pm(t(x))).item()


def _held_out_clips(count=4, max_len=16000):
    """The first `count` clips of bench.py's held-out split, replayed: the
    corpus stream (numpy seed 0) and the trainer's seed-42 split."""
    sys.path.insert(0, str(ROOT / "examples"))
    from train_codec_corpus import synth_clip
    n_clips, valid_frac = 1300, 0.02
    idx = list(range(n_clips))
    random.Random(42).shuffle(idx)
    valid = sorted(idx[: max(1, int(n_clips * valid_frac))])[:count]
    rng = np.random.default_rng(0)
    clips = []
    for i in range(valid[-1] + 1):
        c = synth_clip(rng)
        if i in valid:
            clips.append(c[:max_len])
    return np.stack(clips).astype(np.float32)


def test_persisted_codec_matches_jax(pallas_vq, monkeypatch, capsys):
    x = _held_out_clips()
    ckpt = load_checkpoint(str(CKPT))
    jm = ckpt["restore"](jax.eval_shape(lambda: JSoundStream(**ckpt["config"],
                                                             key=jax.random.PRNGKey(0))))
    pm = load_soundstream(CKPT, device="cpu").eval()
    jx = jnp.asarray(x)
    # the forward's return_recons_only, in three parts: encode, quantize, decode
    jh = _jit(lambda m, a: m.encode_frames(m.process_input(a)))(jm, jx)
    jhq, jcodes, _, _ = _jit(lambda m, h: m.rq(h, train=False))(jm, jh)
    jrecon = np.asarray(_jit(lambda m, h: m.decode(h))(jm, jhq))
    with torch.no_grad():
        codes = pm.tokenize(t(x))
        recon = pm(t(x), return_recons_only=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    peak = np.abs(jrecon).max()
    np.testing.assert_allclose(recon.numpy(), jrecon, rtol=0, atol=1e-3 * peak)
    snr = si_snr(recon, t(x)).numpy()
    jsnr = np.asarray(j_si_snr(jnp.asarray(jrecon), jx))
    np.testing.assert_allclose(snr, jsnr, rtol=0, atol=0.01)
    # JAX's own CPU path: argmin of the squared distance, not K6's formula
    monkeypatch.setattr(jpallas, "on_tpu", lambda: False)
    cpu_codes = _jit(lambda m, h: m.rq(h, train=False)[1])(jm, jh)
    differ = int((np.asarray(cpu_codes) != codes.numpy()).sum())
    with capsys.disabled():
        print(f"\npersisted codec, {len(x)} held-out clips: per-clip SI-SNR port "
              f"{np.round(snr, 3).tolist()} dB, JAX {np.round(jsnr, 3).tolist()} dB (mean "
              f"{snr.mean():.3f}); codes differing from JAX's CPU path: {differ} of "
              f"{codes.numel()}")


def test_loader_refuses_a_config_key_it_does_not_honour(tmp_path):
    """The persisted codec's config with one key changed (the loader reads
    the config before any weight, so the file holds the config alone)."""
    with np.load(CKPT) as data:
        config = json.loads(bytes(data["__meta__"].tobytes()).decode())["config"]
    for key, value, match in (("pad_mode", "symmetric", "pad_mode"),
                              ("compute_dtype", "float16", "compute_dtype"),
                              ("rq_kwargs", {"kmeans_iters": 3}, "kmeans_iters"),
                              ("something_new", 1, "something_new")):
        meta = {"config": dict(config, **{key: value}), "leaf_names": []}
        path = tmp_path / f"{key}.npz"
        np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
        with pytest.raises(NotImplementedError, match=match):
            load_soundstream(path, device="cpu")
