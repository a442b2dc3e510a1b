"""The port's EnCodec (`EncodecWrapper`) against the JAX package on the CPU,
at tests/test_adapters.py's tiny width (channels 4, 32 codes of 16, strides
(2, 4), 30 kbps: 2 quantizers): codes, decode and the forward's contract;
the SLSTM; Meta's checkpoint layout (`make_encodec_sd`) read by both
packages; the default config's shape. Then AudioLM on vq-wav2vec and
EnCodec: the Semantic and Coarse wrappers' losses from `raw_wave`, and a
prompted generation, greedy, token for token JAX's.

The JAX EnCodec is built from its shapes (`jax.eval_shape`) with random
weights (numpy, seeded) and codebooks at the scale of its residuals, carried
to the port by `weights.encodec_state_dict_from_jax`.

vq-wav2vec's ids are (B, frames, groups). The JAX wrappers' forward
flattens them (`reshape(b, -1)`); JAX's Semantic `generate(prime_wave=)`
does not, and its `batch_unique_consecutive` refuses the 3-D ids. The port
flattens at every call site; JAX's AudioLM is given a vq-wav2vec that
flattens itself, the ids its forward would see.

Tolerances: EnCodec's decode and the LSTM 1e-5; the losses 1e-4; the
generated waveform 1e-4 (tests/test_torch_prompt.py's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.audiolm import AudioLM as JAudioLM
from audiolm_pytorch_tpu.models.encodec import EncodecWrapper as JEncodec
from audiolm_pytorch_tpu.models.encodec import _LSTM as JLSTM
from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine
from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic

from audiolm_pytorch_tpu_torch import (AudioLM, CoarseTransformer, CoarseTransformerWrapper,
                                       EncodecWrapper, FineTransformer, SemanticTransformer,
                                       SemanticTransformerWrapper, encodec_state_dict_from_jax)
from audiolm_pytorch_tpu_torch.models.encodec import _LSTM

from test_torch_conditioning import lm_pair
from test_torch_vq_wav2vec import vq_pair
from test_weight_conversion import make_encodec_sd
from torch_port_util import jax_named, jax_replace, t

TINY = dict(channels=4, codebook_dim=16, codebook_size=32, strides=(2, 4), bandwidth=30.0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _leaves(shapes):
    return [(jax.tree_util.keystr(p), a) for p, a in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def encodec_pair(seed=0, **kw):
    """A JAX EncodecWrapper built by shape with random weights and random
    codebooks (the first drawn from the embeddings of a random batch, the
    rest at the scale of the residuals), and the port's copy."""
    kw = dict(TINY, **kw)
    shapes = jax.eval_shape(lambda k: JEncodec(**kw, key=k), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    new = {}
    for name, a in _leaves(shapes):
        leaf = name.split("[<flat")[0]
        if leaf.endswith("initted"):
            v = np.ones(a.shape, bool)
        elif leaf.endswith(("cluster_size", "embed_avg", "codebook")):
            v = np.zeros(a.shape)
        elif a.ndim == 1:  # biases, the LSTMs' included
            v = 0.1 * rng.normal(size=a.shape)
        else:
            v = rng.uniform(-1, 1, size=a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        new[name] = v.astype(a.dtype)
    pm = EncodecWrapper(**kw, device="cpu").eval()
    pm.load_state_dict(encodec_state_dict_from_jax(new))
    x = 0.3 * rng.normal(size=(2, 16 * pm.seq_len_multiple_of)).astype(np.float32)
    with torch.no_grad():
        h = pm.encode_frames(t(x)).numpy()
    rows = h.reshape(-1, h.shape[-1])
    for name in new:
        if name.endswith("codebook[<flat index 0>]"):
            q = int(name.split(".layers[")[1].split("]")[0])
            noise = rng.normal(size=new[name].shape)
            new[name] = (rows[rng.integers(0, len(rows), len(noise))] + 0.1 * rows.std() * noise
                         if q == 0 else 0.3 * rows.std() * 0.5 ** q * noise).astype(np.float32)
    pm.load_state_dict(encodec_state_dict_from_jax(new))
    return jax_replace(shapes, new), pm


@jax.jit
def _jax_codec(m, x):
    emb, codes, _ = m(x, return_encoded=True)
    return emb, codes, m.decode_from_codebook_indices(codes)


def test_encodec_matches_jax():
    jm, pm = encodec_pair()
    assert pm.num_quantizers == jm.num_quantizers == 2
    x = (0.3 * np.random.default_rng(1).normal(size=(2, 40 * 8 + 3))).astype(np.float32)
    jemb, jcodes, jwave = (np.asarray(a) for a in _jax_codec(jm, jnp.asarray(x)))
    with torch.no_grad():
        emb, codes, none = pm(t(x), return_encoded=True)
        assert none is None and codes.shape == (2, 40, 2)
        np.testing.assert_array_equal(codes.numpy(), jcodes)
        assert len(np.unique(jcodes[..., 0])) > 8
        np.testing.assert_allclose(emb.numpy(), jemb, **TOL)
        np.testing.assert_array_equal(pm.tokenize(t(x)).numpy(), jcodes)
        wave = pm.decode_from_codebook_indices(codes)
        np.testing.assert_allclose(wave.numpy(), jwave, **TOL)
        np.testing.assert_array_equal(pm.decode_from_codebook_indices(codes[None]).numpy(),
                                      wave.numpy())
        np.testing.assert_allclose(pm.decode(emb).numpy(), wave.numpy(), **TOL)


def test_lstm_matches_jax():
    jm = JLSTM(12, key=jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    jm.cells = [tuple(jnp.asarray(rng.uniform(-0.3, 0.3, size=a.shape).astype(np.float32))
                      for a in cell) for cell in jm.cells]
    pm = _LSTM(12)
    pm.load_state_dict({k[len("enc_lstm."):]: v for k, v in encodec_state_dict_from_jax(
        {".enc_lstm" + k: v for k, v in jax_named(jm).items()}).items()})
    x = rng.normal(size=(2, 37, 12)).astype(np.float32)
    with torch.no_grad():
        got = pm(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(lambda m, a: m(a))(jm, jnp.asarray(x))),
                               **TOL)


def test_meta_checkpoint_loads_as_in_jax(tmp_path):
    """Meta's layout (weight norm, transposed convolutions, the LSTMs,
    the codebooks) read by both packages: the same weights, codes and
    decode."""
    sd = make_encodec_sd()
    path = tmp_path / "encodec.th"
    torch.save({"best_state": sd}, path)
    jm = jax.eval_shape(lambda k: JEncodec(**TINY, key=k), jax.random.PRNGKey(0))
    jm.load_encodec_checkpoint(path)
    jm = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype) if isinstance(a, jax.ShapeDtypeStruct) else a, jm)
    pm = EncodecWrapper(**TINY, checkpoint_path=path, device="cpu").eval()
    assert pm.pretrained
    np.testing.assert_array_equal(pm.rq.layers[1].codebook.numpy(),
                                  sd["quantizer.vq.layers.1._codebook.embed"].numpy())
    want = encodec_state_dict_from_jax(jax_named(jm))
    for name, value in pm.state_dict().items():
        if not name.endswith("cluster_size"):  # JAX's stays as built
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=name)
    x = (0.3 * np.random.default_rng(4).normal(size=(1, 256))).astype(np.float32)
    _, jcodes, jwave = _jax_codec(jm, jnp.asarray(x))
    with torch.no_grad():
        codes = pm.tokenize(t(x))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_allclose(pm.decode_from_codebook_indices(codes).numpy(),
                                   np.asarray(jwave), **TOL)


def test_default_config():
    """6 kbps at 75 Hz of 10-bit codes: 8 quantizers of 1024 x 128, 24 kHz,
    320 samples a frame (JAX's and the reference's contract)."""
    pm = EncodecWrapper(device="cpu")
    assert (pm.num_quantizers, pm.target_sample_hz, pm.seq_len_multiple_of,
            pm.downsample_factor, pm.rq_groups) == (8, 24000, 320, 320, 1)
    assert pm.rq.codebooks.shape == (8, 1024, 128) and pm.enc_lstm.hidden_size == 512
    with torch.no_grad():
        codes = pm.tokenize(torch.zeros(1, 3 * 320 + 7).normal_(
            generator=torch.Generator().manual_seed(0)))
    assert codes.shape == (1, 3, 8)


# -- AudioLM on vq-wav2vec and EnCodec ---------------------------------------------

# EnCodec at 750 Hz (strides 4, 8), 2 quantizers: 1 coarse, 1 fine
CHAIN_CODEC = dict(TINY, strides=(4, 8), bandwidth=7.5)
LM = dict(dim=32, depth=2, heads=2, dim_head=16, num_residual_streams=4)
SEMANTIC = dict(LM, num_semantic_tokens=12)
COARSE = dict(SEMANTIC, codebook_size=32, num_coarse_quantizers=1)
FINE = dict(LM, codebook_size=32, num_coarse_quantizers=1, num_fine_quantizers=1)
SR = 24000


class _Jitted:
    """A JAX codec or wav2vec whose calls the wrappers make are compiled
    once per shape and input rate (keyword arguments other than the rate
    are fixed by `call`)."""

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


@pytest.fixture(scope="module")
def chain():
    jvq, pvq = vq_pair(seed=5)
    jenc, penc = encodec_pair(seed=6, **CHAIN_CODEC)
    lms = {name: lm_pair(jcls, pcls, cfg, 20 + i) for i, (name, (jcls, pcls, cfg)) in enumerate(
        {"semantic": (JSemantic, SemanticTransformer, SEMANTIC),
         "coarse": (JCoarse, CoarseTransformer, COARSE),
         "fine": (JFine, FineTransformer, FINE)}.items())}
    codec = _Jitted(jenc, lambda m, x, hz: m(x, return_encoded=True, input_sample_hz=hz))
    return dict(lms, jvq=jvq, pvq=pvq, jcodec=codec, pcodec=penc)


def _wave(rng, b, n):
    tt = np.arange(n) / SR
    f0 = rng.uniform(120, 300, size=(b, 1))
    return (0.3 * np.sin(2 * np.pi * f0 * tt) + 0.05 * rng.standard_normal((b, n))).astype(
        np.float32)


def test_wrappers_score_raw_wave_as_jax_does(chain):
    """The Semantic and Coarse wrappers' losses from raw_wave: the
    vq-wav2vec's ids (B, frames, 2) flattened, EnCodec's coarse codes."""
    jwav2vec = _Jitted(chain["jvq"], lambda m, x, hz: m(x, flatten=False, input_sample_hz=hz))
    wave = _wave(np.random.default_rng(7), 2, 320)
    jsem = jw.SemanticTransformerWrapper(transformer=chain["semantic"][0], wav2vec=jwav2vec)
    psem = SemanticTransformerWrapper(transformer=chain["semantic"][1], wav2vec=chain["pvq"])
    jcoarse = jw.CoarseTransformerWrapper(transformer=chain["coarse"][0], wav2vec=jwav2vec,
                                          codec=chain["jcodec"])
    pcoarse = CoarseTransformerWrapper(transformer=chain["coarse"][1], wav2vec=chain["pvq"],
                                       codec=chain["pcodec"])
    for jwrap, pwrap in ((jsem, psem), (jcoarse, pcoarse)):
        want = float(jax.jit(lambda w: jwrap(raw_wave=w, return_loss=True))(jnp.asarray(wave)))
        with torch.no_grad():
            got = pwrap(raw_wave=t(wave), return_loss=True).item()
        np.testing.assert_allclose(got, want, rtol=1e-4)
    whole = SemanticTransformerWrapper(transformer=chain["semantic"][1], wav2vec=chain["pvq"],
                                       unique_consecutive=False)
    with torch.no_grad():
        logits = whole(raw_wave=t(wave))
    assert logits.shape[1] == 1 + 30 * 2  # the start token, 30 frames of 2 groups


def test_audiolm_on_encodec_and_vq_wav2vec_matches_jax(chain, monkeypatch):
    """A 24 kHz prompt continued greedily: the vq-wav2vec's ids and
    EnCodec's codes of the prompt through each stage's prime_wave, against
    JAX's AudioLM whose samplers are made greedy."""
    sample = jw._sample_from_logits
    monkeypatch.setattr(jw, "_sample_from_logits",
                        lambda key, logits, ft, temp: sample(key, logits, ft, 1e-10))
    jwav2vec = _Jitted(chain["jvq"], lambda m, x, hz: m(x, input_sample_hz=hz))
    jlm = JAudioLM(wav2vec=jwav2vec, codec=chain["jcodec"],
                   semantic_transformer=chain["semantic"][0],
                   coarse_transformer=chain["coarse"][0], fine_transformer=chain["fine"][0])
    plm = AudioLM(wav2vec=chain["pvq"], codec=chain["pcodec"],
                  semantic_transformer=chain["semantic"][1],
                  coarse_transformer=chain["coarse"][1], fine_transformer=chain["fine"][1])
    wave = _wave(np.random.default_rng(9), 1, 160)  # 16 vq-wav2vec frames, 5 codec frames
    kw = dict(max_length=48, max_coarse_time_steps=10)
    want = jlm(prime_wave=jnp.asarray(wave), prime_wave_input_sample_hz=SR, **kw)
    got = plm(prime_wave=t(wave), prime_wave_input_sample_hz=SR, temperature=1e-10, **kw)
    want, got = ([w] if not isinstance(w, list) else w for w in (want, got))
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert g is not None and g.shape == w.shape and g.shape[-1] > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_jax_semantic_generate_refuses_vq_wav2vec_prompts(chain):
    """A recorded divergence: JAX's Semantic generate hands vq-wav2vec's
    (B, frames, groups) ids to batch_unique_consecutive, which takes
    (B, N) and raises; the port flattens them, as both forwards do."""
    wave = _wave(np.random.default_rng(10), 1, 160)
    jwav2vec = _Jitted(chain["jvq"], lambda m, x, hz: m(x, flatten=False, input_sample_hz=hz))
    jsem = jw.SemanticTransformerWrapper(transformer=chain["semantic"][0], wav2vec=jwav2vec)
    with pytest.raises(ValueError, match="too many values to unpack"):
        jsem.generate(max_length=48, prime_wave=jnp.asarray(wave))
    psem = SemanticTransformerWrapper(transformer=chain["semantic"][1], wav2vec=chain["pvq"],
                                      unique_consecutive=False)
    flat = chain["pvq"](t(wave))  # (1, 14 frames x 2 groups)
    ids = psem.generate(max_length=flat.shape[1] + 1, prime_wave=t(wave), temperature=1e-10)
    assert flat.shape == (1, 28) and ids.shape == (1, 29)
    np.testing.assert_array_equal(ids[:, :28].numpy(), flat.numpy())
