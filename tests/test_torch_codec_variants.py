"""The rest of the port's codec family against the JAX package on the CPU:
the lookup-free and finite-scalar quantizers alone, residual and grouped
(codes, outputs, the training loss with LFQ's entropy term, gradients
through the straight-through path, decoding codes with -1 among them);
squeeze-excite and GateLoop at T >= 1000; a tiny SoundStream of each
variant (LFQ, FSQ with levels (8, 5, 5, 5), squeeze-excite, GateLoop,
two input channels, constant padding, MusicLMSoundStream's strides):
tokenize, decode_from_codebook_indices and the checkpoint files both ways;
one SoundStreamTrainer G step and D step with an LFQ and with an FSQ codec
against the JAX trainer's step functions; streaming an LFQ codec, and the
squeeze-excite and GateLoop codecs refused by both packages' streaming
classes.

The JAX codecs are built from their shapes (`jax.eval_shape`, with
`jax.ensure_compile_time_eval` so that FSQ's codebook size, a product of
its levels, stays a number) and take the port's seeded weights, with
random biases and norm gains and, for a VQ, random codebooks at the scale
of its residuals. JAX's VQ takes its TPU path, the Pallas nearest-code
kernel (K6) in interpret mode, as in tests/test_torch_codec.py.

A codec of two input channels cannot encode in the JAX package (its
`encode_frames` feeds the first convolution one channel); the port takes
(B, C, T) as the reference does, and is held against the JAX codec's own
modules run in that layout.

Tolerances: the quantizers' outputs and losses 1e-5, their gradients rtol
1e-2 / atol 1e-3; squeeze-excite and GateLoop 1e-5 relative; the codecs'
decode rtol 1e-4 / atol 1e-5 (tests/test_soundstream_variants.py's); the
trainer's steps as tests/test_torch_codec_train.py compares them."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import soundstream as jss
from audiolm_pytorch_tpu.nn.module import combine, partition_trainable, partition_trainable_where
from audiolm_pytorch_tpu.ops import pallas as jpallas
from audiolm_pytorch_tpu.ops import quantize as jq
from audiolm_pytorch_tpu.ops.pallas import vq as jvq
from audiolm_pytorch_tpu.serving import streaming as jstream
from audiolm_pytorch_tpu.training import checkpoint as jckpt
from audiolm_pytorch_tpu.training.trainer import _discr_path

from audiolm_pytorch_tpu_torch import (MusicLMSoundStream, SoundStream, SoundStreamTrainer,
                                       StreamingCodecDecoder, StreamingCodecEncoder,
                                       decode_lookback_frames,
                                       encode_lookback, load_soundstream)
from audiolm_pytorch_tpu_torch.models import soundstream as pss
from audiolm_pytorch_tpu_torch.ops import quantize as pq
from audiolm_pytorch_tpu_torch.training.checkpoint import save_pytree
from audiolm_pytorch_tpu_torch.weights import codec_state_dict_from_jax

from tests.test_torch_codec import TINY
from tests.test_torch_codec_train import FWD, JaxDraws, _Clips, _port_named, _waves
from torch_port_util import jax_named, jax_replace, t

QUANT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-2, atol=1e-3)
DECODE_TOL = dict(rtol=1e-4, atol=1e-5)
LEVELS = (8, 5, 5, 5)


@pytest.fixture
def pallas_vq(monkeypatch):
    """JAX's quantizer on its TPU path: K6, here in interpret mode."""
    monkeypatch.setattr(jpallas, "on_tpu", lambda: True)
    monkeypatch.setattr(jvq, "vq_nearest_code",
                        functools.partial(jvq.vq_nearest_code, interpret=True))


# -- the quantizers ------------------------------------------------------------

QUANTIZERS = {
    ("lfq", "single"): (jq.LFQ, pq.LFQ, dict(codebook_size=64)),
    ("lfq", "residual"): (jq.ResidualLFQ, pq.ResidualLFQ,
                          dict(codebook_size=64, num_quantizers=3, quantize_dropout=True,
                               quantize_dropout_cutoff_index=1, diversity_gamma=0.5)),
    ("lfq", "grouped"): (jq.GroupedResidualLFQ, pq.GroupedResidualLFQ,
                         dict(codebook_size=32, num_quantizers=3, groups=2,
                              quantize_dropout=True, entropy_loss_weight=0.3)),
    ("fsq", "single"): (jq.FSQ, pq.FSQ, dict(levels=LEVELS)),
    ("fsq", "residual"): (jq.ResidualFSQ, pq.ResidualFSQ,
                          dict(levels=LEVELS, num_quantizers=3, quantize_dropout=True,
                               quantize_dropout_cutoff_index=1)),
    ("fsq", "grouped"): (jq.GroupedResidualFSQ, pq.GroupedResidualFSQ,
                         dict(levels=(5, 4, 3), num_quantizers=3, groups=2,
                              quantize_dropout=True)),
}


def _jax_drops(key, quantizer):
    """The dropout indices JAX draws from key, one per residual quantizer in
    order (a grouped quantizer splits key a group first)."""
    rvqs = quantizer.rvqs if hasattr(quantizer, "rvqs") else [quantizer]
    drops = []
    for rvq in rvqs:
        if hasattr(quantizer, "rvqs"):
            key, lk = jax.random.split(key)
        else:
            lk = key
        kd, _ = jax.random.split(lk)
        drops.append(int(jax.random.randint(kd, (), rvq.quantize_dropout_cutoff_index,
                                            rvq.num_quantizers)))
    return drops


@pytest.mark.parametrize("kind,form", list(QUANTIZERS), ids=["-".join(k) for k in QUANTIZERS])
def test_scalar_quantizers_match_jax(kind, form, monkeypatch):
    jcls, pcls, kw = QUANTIZERS[(kind, form)]
    jm = jcls(dim=16, key=jax.random.PRNGKey(3), **kw)
    pm = pcls(dim=16, **kw)
    pm.load_state_dict(codec_state_dict_from_jax(jax_named(jm)))
    rng = np.random.default_rng(4)
    x = (0.7 * rng.normal(size=(2, 40, 16))).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    key = jax.random.PRNGKey(3)  # drops quantizers in both residual forms, unequally by group
    train_kw = {} if form == "single" else dict(key=key)

    def jax_run(m, x):
        out, idx, _, _ = m(x, train=False)
        params, rest = partition_trainable(m)

        def loss(params, x):
            o, _, aux, _ = combine(params, rest)(x, train=True, **train_kw)
            return jnp.sum(o * w) + jnp.sum(aux), (o, jnp.asarray(aux))

        (_, (tout, aux)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
        return out, idx, tout, aux, grads

    jout, jidx, jtout, jaux, (jgm, jgx) = jax.jit(jax_run)(jm, jnp.asarray(x))
    with torch.no_grad():
        out, idx, _ = pm(t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert len(np.unique(np.asarray(jidx))) > 8
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **QUANT_TOL)

    drops = [] if form == "single" else _jax_drops(key, jm)
    assert not drops or max(drops) < kw["num_quantizers"] - 1
    monkeypatch.setattr(pq, "draw_dropout_index", lambda g, lo, hi: drops.pop(0))
    xt = t(x).requires_grad_(True)
    tout, tidx, aux = pm(xt, train=True, **({} if form == "single" else
                                            dict(generator=torch.Generator())))
    assert not drops
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jtout), **QUANT_TOL)
    np.testing.assert_allclose(aux.detach().numpy(), np.asarray(jaux), **QUANT_TOL)
    total = (tout * t(w)).sum() + aux.sum()
    names = [n for n, p in pm.named_parameters()]
    grads = torch.autograd.grad(total, [xt] + [p for p in pm.parameters()], allow_unused=True)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **GRAD)
    want = codec_state_dict_from_jax(jax_named(jgm))
    assert set(want) == set(names)
    for name, g in zip(names, grads[1:]):  # a dropped layer's are zero
        g = torch.zeros_like(want[name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD, err_msg=name)

    # codes with -1 (dropped or padded) decode to nothing
    codes = np.asarray(jidx)
    if form == "single":
        return
    codes = codes.copy()
    codes[..., 1, -1] = -1
    codes[..., 3, 1:] = -1
    want = jax.jit(lambda m, c: m.get_output_from_indices(c))(jm, jnp.asarray(codes))
    got = pm.get_output_from_indices(torch.from_numpy(codes).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **QUANT_TOL)
    short = codes[..., :2]  # fewer quantizers than the model's
    want = jax.jit(lambda m, c: m.get_output_from_indices(c))(jm, jnp.asarray(short))
    got = pm.get_output_from_indices(torch.from_numpy(short).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **QUANT_TOL)


# -- squeeze-excite and GateLoop ------------------------------------------------

def test_squeeze_excite_and_gate_loop_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 1200, 24)).astype(np.float32)
    for jcls, pcls in ((jss.SqueezeExcite, pss.SqueezeExcite), (jss.GateLoop, pss.GateLoop)):
        jm = jcls(24, key=jax.random.PRNGKey(1))
        new = {k: (rng.normal(size=v.shape) * (0.3 if k.endswith("weight") else 0.1)).astype(
            np.float32) for k, v in jax_named(jm).items()}
        jm = jax_replace(jm, new)
        pm = pcls(24)
        pm.load_state_dict(codec_state_dict_from_jax(new))
        want = np.asarray(jax.jit(lambda m, a: m(a))(jm, jnp.asarray(x)))
        with torch.no_grad():
            got = pm(t(x)).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=pcls.__name__)


@pytest.mark.parametrize("a_range", [(0.0, 1e-3), (0.999, 1.0), (0.0, 1.0)],
                         ids=["near_0", "near_1", "all"])
def test_gate_loop_scan_is_the_recurrence(a_range):
    """The Hillis-Steele scan against the recurrence itself, step by step in
    float64, with gates near 0 (a log-space scan underflows there) and
    near 1 (a long memory), over T = 1001 (not a power of 2)."""
    rng = np.random.default_rng(7)
    a = rng.uniform(*a_range, size=(2, 1001, 3))
    b = rng.normal(size=a.shape)
    h, want = np.zeros((2, 3)), []
    for i in range(a.shape[1]):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    got = pss.gate_loop_scan(t(a.astype(np.float32)), t(b.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=1e-4, atol=1e-4)


# -- the codec variants ---------------------------------------------------------

MUSIC = {k: v for k, v in TINY.items() if k not in ("strides", "rq_num_quantizers")}
MUSIC.update(channel_mults=(2, 2, 4, 4))
VARIANTS = {"lfq": dict(use_lookup_free_quantizer=True, codebook_size=64),
            "fsq": dict(use_finite_scalar_quantizer=True, codebook_size=None,
                        finite_scalar_quantizer_levels=LEVELS),
            "squeeze_excite": dict(squeeze_excite=True),
            "gate_loop": dict(use_gate_loop_layers=True),
            "two_channels": dict(input_channels=2),
            "constant_pad": dict(pad_mode="constant"),
            "musiclm": None}


def _codec_args(variant, **overrides):
    return dict(MUSIC if variant == "musiclm" else dict(TINY, **VARIANTS[variant]), **overrides)


def _jax_shapes(variant, seed, **overrides):
    def build(key):
        with jax.ensure_compile_time_eval():
            cls = jss.MusicLMSoundStream if variant == "musiclm" else jss.SoundStream
            return cls(**_codec_args(variant, **overrides), key=key)
    return jax.eval_shape(build, jax.random.PRNGKey(seed))


def variant_pair(variant, seed=0, **overrides):
    """The JAX codec of a variant and its port, with the port's seeded
    weights, random biases and gains, and VQ codebooks at the scale of the
    residuals (initialised)."""
    rng = np.random.default_rng(seed)
    cls = MusicLMSoundStream if variant == "musiclm" else SoundStream
    pm = cls(**_codec_args(variant, **overrides), seed=seed, device="cpu").eval()
    new = _port_named(pm)
    for name, a in new.items():
        leaf = name.split("[<flat")[0].rsplit(".", 1)[-1]
        if leaf in ("bias", "b", "br", "bi"):
            new[name] = (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        elif leaf in ("gamma", "q_scale", "k_scale"):
            new[name] = rng.uniform(0.5, 1.5, size=a.shape).astype(a.dtype)
    pm.load_state_dict(codec_state_dict_from_jax(new))
    if not (pm.use_lookup_free_quantizer or pm.use_finite_scalar_quantizer):
        shape = (2, pm.input_channels, 4 * pm.seq_len_multiple_of)
        with torch.no_grad():
            h = pm.encode_frames(t(rng.normal(size=shape).astype(np.float32))[:, 0]
                                 if pm.input_channels == 1
                                 else t(rng.normal(size=shape).astype(np.float32))).numpy()
        for name, a in new.items():
            if name.endswith("codebook[<flat index 0>]"):
                q = int(name.split(".layers[")[1].split("]")[0])
                new[name] = (h.std() * 0.5 ** q * rng.normal(size=a.shape)).astype(np.float32)
            elif name.endswith("initted[<flat index 0>]"):
                new[name] = np.ones(a.shape, bool)
        pm.load_state_dict(codec_state_dict_from_jax(new))
    return jax_replace(_jax_shapes(variant, seed, **overrides), new), pm


def _jax_two_channels(m, x):
    """The JAX codec's modules on (B, C, T) in the reference's layout: its
    own `encode_frames` and `decode` take one channel."""
    h = m.encoder_init(jnp.transpose(x, (0, 2, 1)))
    for block in m.encoder_blocks:
        h = block(h)
    h = m.encoder_attn(m.encoder_final(h))
    codes = m.rq(h, train=False)[1]
    y = m.decoder_init(m.decoder_attn(m.rq.get_output_from_indices(codes)))
    for block in m.decoder_blocks:
        y = block(y)
    return codes, jnp.transpose(m.decoder_final(y), (0, 2, 1))


def _jax_round_trip(m, x):
    codes = m.tokenize(x)
    return codes, m.decode_from_codebook_indices(codes)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_codec_matches_jax(variant, pallas_vq, tmp_path):
    jm, pm = variant_pair(variant)
    rng = np.random.default_rng(8)
    frames = 64 if variant != "musiclm" else 32
    shape = (2, 2, frames * pm.seq_len_multiple_of) if variant == "two_channels" \
        else (2, frames * pm.seq_len_multiple_of + 5)
    x = (0.5 * rng.normal(size=shape)).astype(np.float32)
    fn = _jax_two_channels if variant == "two_channels" else _jax_round_trip
    jcodes, jwave = (np.asarray(a) for a in jax.jit(fn)(jm, jnp.asarray(x)))
    with torch.no_grad():
        codes = pm.tokenize(t(x))
        wave = pm.decode_from_codebook_indices(codes)
    assert codes.shape == jcodes.shape and codes.shape[2] == frames
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    assert len(np.unique(jcodes[0, :, :, 0])) > 4  # the codes are in use
    assert wave.shape == jwave.shape
    np.testing.assert_allclose(wave.numpy(), jwave, **DECODE_TOL)
    assert pm.codebook_size == jm.codebook_size

    # JAX's SoundStream.save loads in the port; the port's file loads in JAX
    jm.save(str(tmp_path / "jax.npz"))
    loaded = load_soundstream(tmp_path / "jax.npz", device="cpu")
    assert loaded.config == json.loads(json.dumps(dict(jm.configs)))
    for name, value in loaded.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), pm.state_dict()[name].numpy(), err_msg=name)
    save_pytree(tmp_path / "port.npz", _port_named(pm), extra_meta={"config": pm.config})
    back = jax_named(jckpt.load_pytree_into(str(tmp_path / "port.npz"), jm))
    assert set(back) == set(jax_named(jm))
    for name, value in _port_named(pm).items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)


# -- training --------------------------------------------------------------------

class ScalarDraws(JaxDraws):
    """JAX's draws for a codec of LFQ or FSQ layers: one dropout index a
    residual quantizer, no other."""

    def rvq(self, key, rvq, n_rows):
        if rvq.quantize_dropout:
            kd, _ = jax.random.split(key)
            args = (rvq.quantize_dropout_cutoff_index, rvq.num_quantizers)
            self.queue.append(("dropout_index", args, int(jax.random.randint(kd, (), *args))))


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_losses(m, wave, key, discr):
    """The JAX codec's G loss and its breakdown (train, with key) or its D
    loss on one micro-batch."""
    if discr:
        return m(wave, return_discr_loss=True)
    total, terms, _ = m(wave, key=key, train=True, return_loss_breakdown=True)
    return total, jnp.stack(terms)


@pytest.mark.parametrize("variant", ["lfq", "fsq"])
def test_scalar_codec_trainer_step_matches_jax(variant, monkeypatch, tmp_path):
    """One G step and one D step of the port's trainer (2 micro-batches,
    the GAN's losses) against the JAX codec's losses on the same batches,
    dropout draws and weights: the G losses with JAX's training forward
    under the keys JAX's G step splits (LFQ's entropy term in the
    commitment sum, FSQ's zero), the D loss on the weights after the G
    step; the generator's parameters those JAX trains (FSQ's levels
    among them). Then the port's checkpoint read by JAX."""
    jm, pm = variant_pair(variant, seed=11)
    ptr = _port_trainer(tmp_path, pm)
    gen, _ = partition_trainable_where(jm, lambda p: not _discr_path(p))
    assert set(codec_state_dict_from_jax(jax_named(gen))) == set(ptr.gen_names)
    assert variant != "fsq" or any("levels_arr" in name for name in ptr.gen_names)
    draws = ScalarDraws(monkeypatch)
    keys = list(jax.random.split(jax.random.PRNGKey(200), 2))  # JAX's G step's split
    forward = ptr.model.forward

    def drawn_forward(x, **kwargs):
        if kwargs.get("train"):
            draws.codec(keys.pop(0), ptr.model, 0)
        return forward(x, **kwargs)

    monkeypatch.setattr(ptr.model, "forward", drawn_forward)
    try:
        waves = np.stack([_waves(np.random.default_rng(13)) for _ in range(2)])
        want = [_jax_losses(jm, jnp.asarray(w), k, False) for w, k in zip(waves, keys)]
        jg = np.mean([float(total) for total, _ in want])
        jbd = np.mean([np.asarray(terms) for _, terms in want], axis=0)
        pg, pbd = ptr.g_step(t(waves))
        assert not draws.queue and not keys
        np.testing.assert_allclose(pg.item(), jg, **FWD)
        np.testing.assert_allclose(pbd.numpy(), jbd, **FWD)
        if variant == "lfq":
            assert jbd[-1] != 0.0
        else:
            assert jbd[-1] == 0.0 and pbd[-1].item() == 0.0
        after_p = _port_named(ptr.model)
        jafter = jax_replace(jm, after_p)
        jd = np.mean([float(_jax_losses(jafter, jnp.asarray(w), None, True)) for w in waves])
        pd = ptr.d_step(t(waves), False)
        np.testing.assert_allclose(pd.item(), jd, **FWD)
        path = tmp_path / "soundstream.1.ckpt.npz"
        ptr.save(path)
        got = jax_named(jckpt.load_pytree_into(str(path), jm, prefix="['model']"))
        for name, w in _port_named(ptr.model).items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    finally:
        ptr.close()


def _port_trainer(tmp_path, pm):
    """The port's trainer of tests/test_torch_codec_train.py's `_trainers`
    alone."""
    clips = list(_waves(np.random.default_rng(12), 8, 1024))
    return SoundStreamTrainer(pm, dataset=_Clips(clips), results_folder=tmp_path / "port",
                              device="cpu", num_train_steps=10, batch_size=2,
                              grad_accum_every=2, lr=1e-5, warmup_steps=0,
                              apply_grad_penalty_every=2, ema_update_after_step=1,
                              ema_update_every=1, save_results_every=10 ** 9,
                              save_model_every=10 ** 9, valid_frac=0.25)


# -- streaming ---------------------------------------------------------------------

def test_lfq_codec_streams_as_jax_does():
    """An LFQ codec's stream, pushed in uneven pieces, equals JAX's (and
    the offline tokenize); the codes decoded as a stream match JAX's."""
    jm, pm = variant_pair("lfq", seed=17)
    x = (0.5 * np.random.default_rng(18).normal(size=(1, 64 * 8 + 3))).astype(np.float32)
    jenc, penc = (cls(m, chunk_frames=32) for cls, m in (
        (jstream.StreamingCodecEncoder, jm), (StreamingCodecEncoder, pm)))
    pieces = [x[:, :300], x[:, 300:]]
    got = np.concatenate([penc.push(p) for p in pieces] + [penc.flush()], 2)
    want = np.concatenate([np.asarray(jenc.push(p)) for p in pieces] + [jenc.flush()], 2)
    assert got.shape == want.shape == (1, 1, 64, 4)
    np.testing.assert_array_equal(got, want)
    with torch.no_grad():
        np.testing.assert_array_equal(got, pm.tokenize(t(x)).numpy())
    jdec, pdec = (cls(m, chunk_frames=32) for cls, m in (
        (jstream.StreamingCodecDecoder, jm), (StreamingCodecDecoder, pm)))
    bites = [got[:, :, :40], got[:, :, 40:]]
    out = np.concatenate([pdec.push(b) for b in bites] + [pdec.flush()], -1)
    ref = np.concatenate([np.asarray(jdec.push(b)) for b in bites] + [jdec.flush()], -1)
    assert out.shape == (1, 64 * 8)
    np.testing.assert_allclose(out, ref, **DECODE_TOL)


@pytest.mark.parametrize("variant", ["squeeze_excite", "gate_loop"])
def test_unbounded_codecs_refuse_to_stream_in_both(variant):
    shapes = _jax_shapes(variant, 0)
    pm = SoundStream(**_codec_args(variant), discriminators=False, device="cpu")
    assert jstream.decode_lookback_frames(shapes) == decode_lookback_frames(pm) == -1
    assert jstream.encode_lookback(shapes) == encode_lookback(pm) == (-1, -1)
    for jcls, pcls in ((jstream.StreamingCodecEncoder, StreamingCodecEncoder),
                       (jstream.StreamingCodecDecoder, StreamingCodecDecoder)):
        with pytest.raises(ValueError, match="unbounded lookback"):
            jcls(shapes)
        with pytest.raises(ValueError, match="unbounded lookback"):
            pcls(pm)

