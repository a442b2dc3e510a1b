"""The port's conditioned and prompted generation against the JAX package
on the CPU, on a tiny stack (the tiny codec with 4 quantizers and random
codebooks, a tiny HuBERT, LMs of dim 32 and depth 2 conditioned by cross
attention on embeddings of width 24): classifier-free-guidance generation
of the three wrappers token-identical to JAX's samplers at temperature ->
0; prefix-conditioned generation equal to JAX's forward pass recomputed
greedily (JAX's cached sampler loses the history there, a recorded
divergence); AudioLM with `text` (T5 at google/t5-v1_1-small's width, the
hash tokenizer) and a 24 kHz prompt (the wav2vec's ids and the codec's
codes of it, each resampled to 16 kHz, through the Semantic, Coarse and
Fine `prime_wave`), against JAX's AudioLM sampling at temperature -> 0;
and the stage recipe's
HuBERT persisted in persist/hubert_r5_stage.npz equal, leaf for leaf, to
the one JAX builds from its key."""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiolm_pytorch_tpu.models import t5 as jt5
from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.audiolm import AudioLM as JAudioLM
from audiolm_pytorch_tpu.models.hubert import HubertWithKmeans as JHubert
from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine
from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
from audiolm_pytorch_tpu.ops import pallas as jpallas
from audiolm_pytorch_tpu.ops.pallas import vq as jvq

from audiolm_pytorch_tpu_torch import (AudioLM, CoarseTransformer, CoarseTransformerWrapper,
                                       FineTransformer, FineTransformerWrapper,
                                       HubertWithKmeans, SemanticTransformer,
                                       SemanticTransformerWrapper, T5Encoder)
from audiolm_pytorch_tpu_torch.models import t5 as pt5
from audiolm_pytorch_tpu_torch.models.hubert import load_hubert_with_kmeans
from audiolm_pytorch_tpu_torch.weights import hubert_state_dict_from_jax

from test_torch_codec import _tiny_pair
from test_torch_t5 import _hf_state_dict
from test_torch_conditioning import lm_pair
from torch_port_util import jax_named, t

REPO = Path(__file__).resolve().parents[1]
SMALL_T5 = "google/t5-v1_1-small"
COND_DIM = 24
LM = dict(dim=32, depth=2, heads=2, dim_head=16, num_residual_streams=4, has_condition=True,
          cond_dim=COND_DIM)
SEMANTIC = dict(LM, num_semantic_tokens=20)
COARSE = dict(SEMANTIC, codebook_size=64, num_coarse_quantizers=3)
FINE = dict(LM, codebook_size=64, num_coarse_quantizers=3, num_fine_quantizers=1)
HUBERT = dict(dim=48, num_layers=1, heads=4, output_layer=1, codebook_size=20)
GREEDY = dict(temperature=1e-10)
SR_IN = 24000  # the prompts' rate; the codec and the wav2vec take 16 kHz


@pytest.fixture
def pallas_vq(monkeypatch):
    """JAX's quantizer on its TPU path: K6, here in interpret mode."""
    monkeypatch.setattr(jpallas, "on_tpu", lambda: True)
    monkeypatch.setattr(jvq, "vq_nearest_code",
                        functools.partial(jvq.vq_nearest_code, interpret=True))


class _Jitted:
    """A JAX codec or wav2vec whose calls the wrappers make are compiled
    once per shape and input rate."""

    def __init__(self, module, call):
        self.module = module
        self._call = jax.jit(call, static_argnums=(2,))
        self._decode = jax.jit(lambda m, c: m.decode_from_codebook_indices(c))

    def __getattr__(self, name):
        return getattr(self.module, name)

    def __call__(self, x, *args, input_sample_hz=None, **kw):
        return self._call(self.module, x, input_sample_hz)

    def decode_from_codebook_indices(self, codes):
        return self._decode(self.module, codes)


def _lms(cfgs, seed=1):
    return {name: lm_pair(jcls, pcls, cfg, seed + i)
            for i, (name, (jcls, pcls, cfg)) in enumerate(cfgs.items())}


@pytest.fixture(scope="module")
def stack():
    jcodec, pcodec = _tiny_pair(1, seed=4)
    jhub = jax.jit(lambda: JHubert(**HUBERT, key=jax.random.PRNGKey(3)))()
    phub = HubertWithKmeans(**HUBERT, device="cpu")
    phub.load_state_dict(hubert_state_dict_from_jax(jax_named(jhub)))
    lms = _lms({"semantic": (JSemantic, SemanticTransformer, SEMANTIC),
                "coarse": (JCoarse, CoarseTransformer, COARSE),
                "fine": (JFine, FineTransformer, FINE)})
    return dict(lms, jcodec=_Jitted(jcodec, lambda m, x, hz: m(
                    x, return_encoded=True, input_sample_hz=hz)), pcodec=pcodec,
                jhub=_Jitted(jhub, lambda m, x, hz: m(x, flatten=False, input_sample_hz=hz)),
                phub=phub)


def _text(rng, b=2, n=4):
    te = rng.normal(size=(b, n, COND_DIM)).astype(np.float32)
    te[1, 2:] = 0.0
    return te


def _wave(rng, b, seconds, sr=SR_IN):
    n = int(seconds * sr)
    tt = np.arange(n) / sr
    f0 = rng.uniform(120, 300, size=(b, 1))
    return (0.3 * np.sin(2 * np.pi * f0 * tt) + 0.05 * rng.standard_normal((b, n))).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["semantic", "coarse", "fine"])
def test_cfg_generation_matches_jax(stack, kind):
    """Guidance at cond_scale 3 (the [cond | uncond] rows in one batch, one
    KV cache), greedy: the same tokens as JAX's samplers."""
    jm, pm = stack[kind]
    rng = np.random.default_rng(10)
    te = _text(rng)
    kw = dict(GREEDY, cond_scale=3.0)
    if kind == "semantic":
        prompt = rng.integers(0, 20, size=(2, 4))
        want = jw.SemanticTransformerWrapper(transformer=jm).generate(
            max_length=14, prime_ids=jnp.asarray(prompt), text_embeds=jnp.asarray(te), **kw)
        got = SemanticTransformerWrapper(transformer=pm).generate(
            max_length=14, prime_ids=t(prompt), text_embeds=t(te), **kw)
    elif kind == "coarse":
        sem = rng.integers(0, 20, size=(2, 5))
        want = jw.CoarseTransformerWrapper(transformer=jm).generate(
            semantic_token_ids=jnp.asarray(sem), max_time_steps=4,
            text_embeds=jnp.asarray(te), **kw)
        got = CoarseTransformerWrapper(transformer=pm).generate(
            semantic_token_ids=t(sem), max_time_steps=4, text_embeds=t(te), **kw)
    else:
        coarse = rng.integers(0, 64, size=(2, 5, 3))
        want = jw.FineTransformerWrapper(transformer=jm).generate(
            coarse_token_ids=jnp.asarray(coarse), text_embeds=jnp.asarray(te), **kw)
        got = FineTransformerWrapper(transformer=pm).generate(
            coarse_token_ids=t(coarse), text_embeds=t(te), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() > got.numel() // 2


_jax_prefix_logits = jax.jit(lambda m, ids, te, s: m.forward_with_cond_scale(
    ids=ids, text_embeds=te, cond_scale=s), static_argnums=(3,))


@pytest.mark.parametrize("cond_scale", [1.0, 3.0])
def test_prefix_generation_equals_greedy_recompute(cond_scale):
    """Under prefix conditioning the port runs the whole sequence at each
    step. Its tokens are JAX's forward pass recomputed greedily: each one is
    the argmax of JAX's logits over the prompt and the tokens before it.
    JAX's own sampler, which feeds only the new token to a transformer that
    keeps no cache there, gives other tokens."""
    cfg = dict(SEMANTIC, depth=1, cond_as_self_attn_prefix=True)
    jm, pm = lm_pair(JSemantic, SemanticTransformer, cfg, 21)
    rng = np.random.default_rng(22)
    te = _text(rng)
    prompt = np.array([[3, 5, 7, 2], [4, 9, 1, 6]])
    kw = dict(GREEDY, cond_scale=cond_scale, filter_thres=0.0)
    got = SemanticTransformerWrapper(transformer=pm).generate(
        max_length=16, prime_ids=t(prompt), text_embeds=t(te), **kw).numpy()
    seq = np.where(got < 0, 0, got)
    logits = np.asarray(_jax_prefix_logits(jm, jnp.asarray(seq), jnp.asarray(te), cond_scale))
    for row in range(2):
        n = int((got[row] >= 0).sum())
        # the token at position i was sampled from the logits of [start] + ids[:i]
        np.testing.assert_array_equal(got[row, 4:n], logits[row, 4:n].argmax(-1))
        if n < 16:  # cut by EOS, which the greedy pass picked
            assert logits[row, n].argmax() == pm.eos_id
    assert (got >= 0).sum() >= 20
    jax_sampler = np.asarray(jw.SemanticTransformerWrapper(transformer=jm).generate(
        max_length=16, prime_ids=jnp.asarray(prompt), text_embeds=jnp.asarray(te), **kw))
    assert not np.array_equal(jax_sampler, got)


def _t5_pair():
    """JAX's small T5 built by shape and the port's, both loaded from one
    synthetic HF-layout state dict."""
    sd = _hf_state_dict(seed=31)
    jenc = jax.eval_shape(lambda: jt5.T5Encoder(SMALL_T5, load_pretrained=False))
    jenc.load_torch_state_dict(sd)
    penc = T5Encoder(SMALL_T5, seed=31, device="cpu").eval()
    penc.load_torch_state_dict(sd)
    return jenc, penc


def test_audiolm_text_and_prime_wave_match_jax(stack, pallas_vq, monkeypatch):
    """AudioLM with `text` (each conditioned stage gets the T5 embedding the
    semantic stage's encoder gives once) and a 24 kHz prompt, greedy, against
    JAX's AudioLM whose samplers are made greedy; then without the prompt."""
    cfgs = {"semantic": (JSemantic, SemanticTransformer, dict(SEMANTIC, cond_dim=None,
                                                              t5_name=SMALL_T5)),
            "coarse": (JCoarse, CoarseTransformer, dict(COARSE, cond_dim=None, t5_name=SMALL_T5)),
            "fine": (JFine, FineTransformer, dict(FINE, has_condition=False, cond_dim=None,
                                                  t5_name=SMALL_T5))}
    lms = _lms(cfgs, seed=40)
    jenc, penc = _t5_pair()
    monkeypatch.setitem(jt5._ENCODERS, SMALL_T5, jenc)
    monkeypatch.setattr(jt5, "_get_tokenizer", lambda name: None)
    monkeypatch.setitem(pt5._ENCODERS, (SMALL_T5, "cpu"), penc)
    sample = jw._sample_from_logits
    monkeypatch.setattr(jw, "_sample_from_logits",
                        lambda key, logits, ft, temp: sample(key, logits, ft, 1e-10))
    jlm = JAudioLM(wav2vec=stack["jhub"], codec=stack["jcodec"],
                   semantic_transformer=lms["semantic"][0], coarse_transformer=lms["coarse"][0],
                   fine_transformer=lms["fine"][0])
    plm = AudioLM(wav2vec=stack["phub"], codec=stack["pcodec"],
                  semantic_transformer=lms["semantic"][1], coarse_transformer=lms["coarse"][1],
                  fine_transformer=lms["fine"][1])
    wave = _wave(np.random.default_rng(13), 1, 0.1)
    kw = dict(text=["dog barking"], max_length=12, max_coarse_time_steps=3)
    want = jlm(prime_wave=jnp.asarray(wave), prime_wave_input_sample_hz=SR_IN, **kw)
    got = plm(prime_wave=t(wave), prime_wave_input_sample_hz=SR_IN, **GREEDY, **kw)
    want, got = ([w] if not isinstance(w, list) else w for w in (want, got))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="text"):
        plm(max_length=4)


def test_hubert_stage_weights_are_the_recipes():
    """persist/hubert_r5_stage.npz holds the stage recipe's HuBERT: JAX's
    HubertWithKmeans from PRNGKey(1) at dim 256, 3 layers, 4 heads, with the
    corpus centres, leaf for leaf; the port loads it whole."""
    path = REPO / "persist" / "hubert_r5_stage.npz"
    cfg = dict(dim=256, num_layers=3, heads=4, output_layer=3, codebook_size=100)
    jm = jax.jit(lambda: JHubert(**cfg, key=jax.random.PRNGKey(1)))()
    want = jax_named(jm)
    want[".cluster_centers"] = np.load(REPO / "results_quality" / "audiolm_r5" / "kmeans.npy")
    pm = load_hubert_with_kmeans(path, device="cpu")
    got = hubert_state_dict_from_jax(want)
    assert set(got) == set(pm.state_dict())
    for name, a in pm.state_dict().items():
        np.testing.assert_allclose(a.numpy(), got[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    assert pm.codebook_size == 100 and pm.output_layer == 3
