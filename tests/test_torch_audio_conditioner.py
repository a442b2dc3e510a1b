"""The wrappers' and AudioLM's `audio_conditioner` against the JAX package on
the CPU: a deterministic conditioner (a fixed projection of a wave's frame
statistics, one projection a namespace, written once for numpy-like arrays
so that JAX and the port run the same arithmetic) conditions the three LMs
(dim 32, depth 1, cross attention over its embeddings of width 16); the
wrappers' eval losses from `raw_wave` (the Fine wrapper's codes from the
tiny codec), and AudioLM's greedy ids of each stage against JAX's
wrappers, given the conditioner's embeddings as `text_embeds` (JAX's
AudioLM samples at temperature 1 alone). The port's AudioLM also
conditions every stage on its embeddings of a prompt when it has no text;
that is held against its own wrappers called in turn (JAX's AudioLM asks
for text there, which its Semantic stage then refuses).

Tolerances: 2e-3 on losses; ids identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine
from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic

from audiolm_pytorch_tpu_torch import (AudioLM, CoarseTransformer, CoarseTransformerWrapper,
                                       FineTransformer, FineTransformerWrapper,
                                       HubertWithKmeans, SemanticTransformer,
                                       SemanticTransformerWrapper, decode_acoustic_tokens)
from audiolm_pytorch_tpu_torch.utils import AudioConditionerBase

from test_torch_codec import _tiny_pair, pallas_vq  # noqa: F401
from test_torch_conditioning import lm_pair
from torch_port_util import t

TOL = dict(rtol=2e-3, atol=2e-3)
COND = 16
LM = dict(dim=32, depth=1, heads=2, dim_head=16, num_residual_streams=1, has_condition=True,
          cond_dim=COND)
SEMANTIC = dict(LM, num_semantic_tokens=20)
COARSE = dict(SEMANTIC, codebook_size=64, num_coarse_quantizers=3)
FINE = dict(LM, codebook_size=64, num_coarse_quantizers=3, num_fine_quantizers=1)
SEEDS = {"semantic": 1, "coarse": 2, "fine": 3}


class Conditioner(AudioConditionerBase):
    """(B, 4, COND) from a wave (B, T): the mean, RMS and mean |x| of each
    quarter of the wave through a fixed (3, COND) projection of its
    namespace. `xp` is jax.numpy or torch, `to` makes an array of it."""

    def __init__(self, xp, to):
        self.xp, self.to = xp, to
        self.proj = {ns: np.random.default_rng(seed).normal(size=(3, COND)).astype(np.float32)
                     for ns, seed in SEEDS.items()}
        self.calls = []

    def __call__(self, *, wavs, namespace):
        self.calls.append(namespace)
        xp = self.xp
        b, n = wavs.shape
        f = wavs[:, : n // 4 * 4].reshape(b, 4, -1)
        feats = xp.stack([f.mean(-1), xp.sqrt((f * f).mean(-1)), xp.abs(f).mean(-1)], -1)
        return feats @ self.to(self.proj[namespace])


def _conditioners():
    return Conditioner(jnp, jnp.asarray), Conditioner(torch, torch.from_numpy)


def _lms():
    return {kind: lm_pair(jcls, pcls, cfg, seed=SEEDS[kind]) for kind, (jcls, pcls, cfg) in
            dict(semantic=(JSemantic, SemanticTransformer, SEMANTIC),
                 coarse=(JCoarse, CoarseTransformer, COARSE),
                 fine=(JFine, FineTransformer, FINE)).items()}


@pytest.mark.parametrize("kind", ["semantic", "coarse", "fine"])
def test_wrapper_losses_with_an_audio_conditioner_match_jax(kind, pallas_vq):
    jm, pm = _lms()[kind]
    jcond, pcond = _conditioners()
    rng = np.random.default_rng(4)
    wave = (0.5 * rng.normal(size=(2, 7 * 8))).astype(np.float32)
    if kind == "semantic":
        ids = rng.integers(0, 20, size=(2, 9))
        want = jax.jit(lambda m, i, w: jw.SemanticTransformerWrapper(
            transformer=m, audio_conditioner=jcond)(semantic_token_ids=i, raw_wave=w,
                                                    return_loss=True))(
            jm, jnp.asarray(ids), jnp.asarray(wave))
        wrapper = SemanticTransformerWrapper(transformer=pm, audio_conditioner=pcond)
        args = (t(ids),)
    elif kind == "coarse":
        sem, coarse = rng.integers(0, 20, size=(2, 5)), rng.integers(0, 64, size=(2, 7, 3))
        want = jax.jit(lambda m, s_, c, w: jw.CoarseTransformerWrapper(
            transformer=m, audio_conditioner=jcond)(semantic_token_ids=s_, coarse_token_ids=c,
                                                    raw_wave=w, return_loss=True))(
            jm, jnp.asarray(sem), jnp.asarray(coarse), jnp.asarray(wave))
        wrapper = CoarseTransformerWrapper(transformer=pm, audio_conditioner=pcond)
        args = (t(sem), t(coarse))
    else:
        jcodec, pcodec = _tiny_pair(1, seed=4)
        want = jax.jit(lambda m, c, w: jw.FineTransformerWrapper(
            transformer=m, codec=c, audio_conditioner=jcond)(raw_wave=w, return_loss=True))(
            jm, jcodec, jnp.asarray(wave))
        wrapper = FineTransformerWrapper(transformer=pm, codec=pcodec, audio_conditioner=pcond)
        args = ()
    with torch.no_grad():
        got = wrapper(*args, raw_wave=t(wave), return_loss=True)
        np.testing.assert_allclose(got.item(), float(want), **TOL)
        assert pcond.calls == [kind] and jcond.calls == [kind]
        # the condition reaches the loss (another projection: the context is
        # layer-normed, so a scaled one would not show)
        pcond.proj[kind] = -pcond.proj[kind][::-1].copy()
        other = wrapper(*args, raw_wave=t(wave), return_loss=True)
        assert abs(other.item() - got.item()) > 1e-3
        with pytest.raises(ValueError, match="audio_conditioner"):
            wrapper(*args, raw_wave=t(wave), text_embeds=torch.ones(2, 3, COND),
                    return_loss=True)
    with pytest.raises(ValueError, match="has_condition"):
        type(wrapper)(transformer=type(pm)(**{k: v for k, v in (SEMANTIC if kind == "semantic"
                                                                else COARSE if kind == "coarse"
                                                                else FINE).items()
                                              if k not in ("has_condition", "cond_dim")},
                                           device="cpu"), audio_conditioner=pcond)


def _spy(monkeypatch, wrapper, out):
    generate = wrapper.generate

    def spied(**kw):
        res = generate(**kw)
        out.append(res)
        return res

    monkeypatch.setattr(wrapper, "generate", spied)


def test_audiolm_greedy_ids_with_an_audio_conditioner_match_jax(pallas_vq, monkeypatch):
    lms = _lms()
    jcodec, pcodec = _tiny_pair(1, seed=4)
    jcond, pcond = _conditioners()
    ref_wave = (0.5 * np.random.default_rng(5).normal(size=(2, 64))).astype(np.float32)
    te = pcond(wavs=t(ref_wave), namespace="semantic")
    audiolm = AudioLM(codec=pcodec, semantic_transformer=lms["semantic"][1],
                      coarse_transformer=lms["coarse"][1], fine_transformer=lms["fine"][1],
                      audio_conditioner=pcond)
    stages = []
    for name in ("semantic", "coarse", "fine"):
        _spy(monkeypatch, getattr(audiolm, name), stages)
    audiolm(batch_size=2, text_embeds=te, max_length=10, max_coarse_time_steps=4,
            temperature=0.0)
    jte = jnp.asarray(te.numpy())
    sem = jw.SemanticTransformerWrapper(transformer=lms["semantic"][0], audio_conditioner=jcond
                                        ).generate(text_embeds=jte, batch_size=2, max_length=10,
                                                   temperature=0.0)
    coarse = jw.CoarseTransformerWrapper(transformer=lms["coarse"][0], codec=jcodec,
                                         audio_conditioner=jcond).generate(
        semantic_token_ids=sem, text_embeds=jte, max_time_steps=4, temperature=0.0)
    fine = jw.FineTransformerWrapper(transformer=lms["fine"][0], codec=jcodec,
                                     audio_conditioner=jcond).generate(
        coarse_token_ids=coarse, text_embeds=jte, temperature=0.0)
    for got, want in zip(stages, (sem, coarse)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the Fine stage gives the decode of the coarse and fine codes
    with torch.no_grad():
        want = decode_acoustic_tokens(pcodec, torch.cat([t(np.asarray(coarse)),
                                                         t(np.asarray(fine))], -1))
    got, want = (w if isinstance(w, list) else [w] for w in (stages[2], want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)
    assert pcond.calls == ["semantic"] and not jcond.calls  # only the test's own call


def test_audiolm_conditions_each_stage_on_its_prompt():
    """With a prompt and no text, each stage conditions on the conditioner's
    embeddings of the prompt in its own namespace: the chain equals its
    wrappers called in turn with those embeddings."""
    lms = _lms()
    _, codec = _tiny_pair(1, seed=4)
    wav2vec = HubertWithKmeans(dim=48, num_layers=1, heads=4, output_layer=1, codebook_size=20,
                               device="cpu")
    _, cond = _conditioners()
    audiolm = AudioLM(wav2vec=wav2vec, codec=codec, semantic_transformer=lms["semantic"][1],
                      coarse_transformer=lms["coarse"][1], fine_transformer=lms["fine"][1],
                      audio_conditioner=cond)
    prime = t((0.3 * np.sin(np.arange(1600) * 0.05)[None]).astype(np.float32))
    kw = dict(temperature=0.0, prime_wave=prime, prime_wave_input_sample_hz=16000)
    wave = audiolm(max_length=12, max_coarse_time_steps=4, **kw)
    assert cond.calls == ["semantic", "coarse", "fine"]
    sem = audiolm.semantic.generate(max_length=12, **kw)
    coarse = audiolm.coarse.generate(semantic_token_ids=sem, max_time_steps=4,
                                     text_embeds=cond(wavs=prime, namespace="coarse"), **kw)
    fine = audiolm.fine.generate(coarse_token_ids=coarse, reconstruct_wave=True,
                                 text_embeds=cond(wavs=prime, namespace="fine"), **kw)
    got, want = (w if isinstance(w, list) else [w] for w in (wave, fine))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)
