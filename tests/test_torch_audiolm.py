"""The port's audio paths of the Coarse and Fine wrappers and AudioLM end
to end, against the JAX package on the CPU, on a tiny stack (the sizes of
tests/test_audiolm_e2e.py: the tiny codec with 4 quantizers and random
codebooks, LMs of dim 32 and depth 1): `decode_acoustic_tokens` on a
uniform grid and on ragged rows (one decode per row, padded to a length
bucket), and its `has_padding` modes (None, False, True) through the
Coarse wrapper and AudioLM; the Coarse `generate` with `reconstruct_wave`, the Fine `generate`
with `prime_wave` and `reconstruct_wave`, both at temperature -> 0; the
eval forward of both wrappers from `raw_wave_for_codec`; and the port's
`AudioLM` chain against its three wrappers called in turn with one
generator. JAX's quantizer takes K6 in interpret mode, as in
tests/test_torch_codec.py.

Tolerances: 1e-4 on waveforms (float32, summation order only, as the tiny
codec's test); 2e-3 on logits; codes identical."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine
from audiolm_pytorch_tpu.ops import pallas as jpallas
from audiolm_pytorch_tpu.ops.pallas import vq as jvq

from audiolm_pytorch_tpu_torch import (AudioLM, CoarseTransformer, CoarseTransformerWrapper,
                                       FineTransformer, FineTransformerWrapper,
                                       SemanticTransformer, SemanticTransformerWrapper,
                                       TransformerTrainStep, decode_acoustic_tokens)

from test_torch_codec import _tiny_pair
from torch_port_util import load_into, t

WAVE_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=2e-3, atol=2e-3)
LM = dict(dim=32, depth=1, heads=2, dim_head=16, num_residual_streams=1)
SEMANTIC = dict(LM, num_semantic_tokens=20)
COARSE = dict(SEMANTIC, codebook_size=64, num_coarse_quantizers=3)
FINE = dict(LM, codebook_size=64, num_coarse_quantizers=3, num_fine_quantizers=1)
DS = 8  # the tiny codec's samples per frame


@pytest.fixture
def pallas_vq(monkeypatch):
    """JAX's quantizer on its TPU path: K6, here in interpret mode."""
    monkeypatch.setattr(jpallas, "on_tpu", lambda: True)
    monkeypatch.setattr(jvq, "vq_nearest_code",
                        functools.partial(jvq.vq_nearest_code, interpret=True))


class _Compiled:
    """The JAX codec with its two calls the wrappers make compiled once per
    shape (op by op, each new length recompiles every op of the codec)."""

    def __init__(self, codec):
        self.codec = codec
        self._call = jax.jit(lambda m, x: m(x, return_encoded=True))
        self._decode = jax.jit(lambda m, c: m.decode_from_codebook_indices(c))

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def __call__(self, x, return_encoded, input_sample_hz=None):
        assert return_encoded and input_sample_hz is None
        return self._call(self.codec, x)

    def decode_from_codebook_indices(self, codes):
        return self._decode(self.codec, codes)


@pytest.fixture(scope="module")
def stack():
    jcodec, pcodec = _tiny_pair(1, seed=4)
    jc = JCoarse(**COARSE, key=jax.random.PRNGKey(1))
    jf = JFine(**FINE, key=jax.random.PRNGKey(2))
    return dict(jcodec=_Compiled(jcodec), pcodec=pcodec, jc=jc, jf=jf,
                pc=load_into(CoarseTransformer(**COARSE, device="cpu"), jc),
                pf=load_into(FineTransformer(**FINE, device="cpu"), jf))


def _assert_waves(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **WAVE_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **WAVE_TOL)


def test_decode_acoustic_tokens_matches_jax(stack):
    grid = np.random.default_rng(0).integers(0, 64, size=(3, 10, 4))
    with torch.no_grad():
        uniform = decode_acoustic_tokens(stack["pcodec"], t(grid))
        assert uniform.shape == (3, 10 * DS)
        _assert_waves(uniform, jw.decode_acoustic_tokens(stack["jcodec"], jnp.asarray(grid)))
        ragged = grid.copy()
        ragged[0, 3, 2] = -1  # one frame dropped
        ragged[1, 6:] = -1    # a row cut short
        ragged[2] = -1        # an empty row
        for bucket in (64, 4):
            got = decode_acoustic_tokens(stack["pcodec"], t(ragged), length_bucket=bucket)
            assert [None if w is None else w.shape[0] for w in got] == [9 * DS, 6 * DS, None]
            _assert_waves(got, jw.decode_acoustic_tokens(stack["jcodec"], jnp.asarray(ragged),
                                                         length_bucket=bucket))
        # coarse codes only: fewer quantizers than the codec has
        _assert_waves(decode_acoustic_tokens(stack["pcodec"], t(grid[..., :3])),
                      jw.decode_acoustic_tokens(stack["jcodec"], jnp.asarray(grid[..., :3])))


@pytest.mark.parametrize("has_padding", [None, False, True])
def test_has_padding_follows_jax(stack, has_padding):
    """None looks for pad on the host, False takes the batched decode (pad
    codes dropped from the sum, no host sync), True the per-row path, in the
    decode and through the Coarse wrapper's and AudioLM's generate."""
    grid = np.random.default_rng(5).integers(0, 64, size=(2, 8, 4))
    ragged = grid.copy()
    ragged[1, 5:] = -1
    with torch.no_grad():
        for g in (grid, ragged):
            got = decode_acoustic_tokens(stack["pcodec"], t(g), has_padding=has_padding)
            want = jw.decode_acoustic_tokens(stack["jcodec"], jnp.asarray(g),
                                             has_padding=has_padding)
            assert isinstance(got, list) == isinstance(want, list) == (
                has_padding is True or (has_padding is None and g is ragged))
            _assert_waves(got, want)
    sem = np.random.default_rng(1).integers(0, 20, size=(2, 8))
    kw = dict(max_time_steps=5, temperature=1e-10, reconstruct_wave=True,
              has_padding=has_padding)
    want = jw.CoarseTransformerWrapper(transformer=stack["jc"], codec=stack["jcodec"]).generate(
        semantic_token_ids=jnp.asarray(sem), **kw)
    got = CoarseTransformerWrapper(transformer=stack["pc"], codec=stack["pcodec"]).generate(
        semantic_token_ids=t(sem), **kw)
    _assert_waves(got, want)
    audiolm = AudioLM(codec=stack["pcodec"], coarse_transformer=stack["pc"],
                      fine_transformer=stack["pf"],
                      semantic_transformer=SemanticTransformer(**SEMANTIC, seed=1, device="cpu"))
    wave = audiolm(batch_size=2, max_length=6, max_coarse_time_steps=3, has_padding=has_padding,
                   generator=torch.Generator().manual_seed(3))
    assert isinstance(wave, list) == (has_padding is True) or has_padding is None


def test_coarse_generate_reconstruct_wave_matches_jax(stack):
    sem = np.random.default_rng(1).integers(0, 20, size=(2, 8))
    kw = dict(max_time_steps=5, temperature=1e-10)
    want = jw.CoarseTransformerWrapper(transformer=stack["jc"], codec=stack["jcodec"]).generate(
        semantic_token_ids=jnp.asarray(sem), reconstruct_wave=True, **kw)
    wrapper = CoarseTransformerWrapper(transformer=stack["pc"], codec=stack["pcodec"])
    got = wrapper.generate(semantic_token_ids=t(sem), reconstruct_wave=True, **kw)
    _assert_waves(got, want)
    grid = wrapper.generate(semantic_token_ids=t(sem), **kw)
    with torch.no_grad():
        _assert_waves(got, decode_acoustic_tokens(stack["pcodec"], grid))


def test_fine_generate_prime_wave_matches_jax(pallas_vq, stack):
    rng = np.random.default_rng(2)
    coarse = rng.integers(0, 64, size=(2, 6, 3))
    prime = (0.5 * rng.normal(size=(2, 3 * DS + 5))).astype(np.float32)  # 3 frames, curtailed
    kw = dict(temperature=1e-10)
    jwrap = jw.FineTransformerWrapper(transformer=stack["jf"], codec=stack["jcodec"])
    pwrap = FineTransformerWrapper(transformer=stack["pf"], codec=stack["pcodec"])
    want = jwrap.generate(coarse_token_ids=jnp.asarray(coarse), prime_wave=jnp.asarray(prime),
                          **kw)
    got = pwrap.generate(coarse_token_ids=t(coarse), prime_wave=t(prime), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with torch.no_grad():
        prime_codes = stack["pcodec"](t(prime), return_encoded=True)[1][..., 3:]
    np.testing.assert_array_equal(got[:, :3].numpy(), prime_codes.numpy())
    want = jwrap.generate(coarse_token_ids=jnp.asarray(coarse), prime_wave=jnp.asarray(prime),
                          reconstruct_wave=True, **kw)
    got = pwrap.generate(coarse_token_ids=t(coarse), prime_wave=t(prime),
                         reconstruct_wave=True, **kw)
    assert got.shape == (2, 6 * DS)
    _assert_waves(got, want)


def test_eval_forward_from_raw_wave_matches_jax(pallas_vq, stack):
    rng = np.random.default_rng(3)
    wave = (0.5 * rng.normal(size=(2, 7 * DS))).astype(np.float32)
    sem = rng.integers(0, 20, size=(2, 5))
    want = jw.CoarseTransformerWrapper(transformer=stack["jc"], codec=stack["jcodec"])(
        semantic_token_ids=jnp.asarray(sem), raw_wave_for_codec=jnp.asarray(wave))
    with torch.no_grad():
        got = CoarseTransformerWrapper(transformer=stack["pc"], codec=stack["pcodec"])(
            t(sem), raw_wave_for_codec=t(wave))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    want = jw.FineTransformerWrapper(transformer=stack["jf"], codec=stack["jcodec"])(
        raw_wave=jnp.asarray(wave), return_loss=True)
    with torch.no_grad():
        got = FineTransformerWrapper(transformer=stack["pf"], codec=stack["pcodec"])(
            raw_wave_for_codec=t(wave), return_loss=True)
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_audiolm_chain_matches_its_wrappers():
    _, codec = _tiny_pair(1, seed=5)
    semantic = SemanticTransformer(**SEMANTIC, seed=1, device="cpu")
    coarse = CoarseTransformer(**COARSE, seed=2, device="cpu")
    fine = FineTransformer(**FINE, seed=3, device="cpu")
    audiolm = AudioLM(codec=codec, semantic_transformer=semantic, coarse_transformer=coarse,
                      fine_transformer=fine)
    wave = audiolm(batch_size=2, max_length=12, max_coarse_time_steps=6,
                   generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    sem = SemanticTransformerWrapper(transformer=semantic).generate(
        batch_size=2, max_length=12, generator=g)
    co = CoarseTransformerWrapper(transformer=coarse, codec=codec).generate(
        semantic_token_ids=sem, max_time_steps=6, generator=g)
    fi = FineTransformerWrapper(transformer=fine, codec=codec).generate(
        coarse_token_ids=co, generator=g)
    with torch.no_grad():
        want = decode_acoustic_tokens(codec, torch.cat([co, fi], -1))
    frames = (co >= 0).all(-1).sum(-1).tolist()
    if isinstance(want, list):  # EOS cut a row short
        assert [None if w is None else w.shape[-1] for w in wave] == \
            [f * DS or None for f in frames]
        waves = [w for w in wave if w is not None]
        for got, ref in zip(waves, [w for w in want if w is not None]):
            assert torch.equal(got, ref)
    else:
        assert wave.shape == (2, 6 * DS) and frames == [6, 6]
        assert torch.equal(wave, want)
        waves = [wave]
    assert all(torch.isfinite(w).all() for w in waves)
    # a prompt needs its rate, and this chain's wav2vec; text needs a conditioned stage
    with pytest.raises(ValueError, match="sample_hz"):
        audiolm(prime_wave=torch.zeros(1, 64))
    with pytest.raises(ValueError, match="wav2vec"):
        audiolm(prime_wave=torch.zeros(1, 64), prime_wave_input_sample_hz=16000)
    with pytest.raises(ValueError, match="text"):
        audiolm(text=["a sentence"])


def test_train_step_leaves_the_wrappers_codec_alone():
    """A wrapper holding a codec trains its transformer only: with weight
    decay, a codec among the optimised parameters would shrink."""
    _, codec = _tiny_pair(1, seed=6)
    before = {n: p.clone() for n, p in codec.named_parameters()}
    coarse = CoarseTransformer(**COARSE, seed=4, device="cpu")
    start = coarse.coarse_embedding.detach().clone()
    step = TransformerTrainStep(CoarseTransformerWrapper(transformer=coarse, codec=codec),
                                wd=0.1, device="cpu")
    rng = np.random.default_rng(8)
    step.step(t(rng.integers(0, 20, size=(2, 6))), t(rng.integers(0, 64, size=(2, 12))))
    assert not torch.equal(coarse.coarse_embedding, start)
    assert all(torch.equal(p, before[n]) for n, p in codec.named_parameters())
