"""The port's T5 text encoder and resampler against the JAX package on the
CPU: the hash tokenizer's ids (the fallback both packages ship, with no
tokenizer files in the repository) equal JAX's exactly; `T5Encoder` at
google/t5-v1_1-small's width (the smallest config JAX's encoder takes) on
up to 8 tokens, with JAX's weights through `t5_state_dict_from_jax` and with
the same synthetic HF-layout state dict loaded by both packages'
`load_torch_state_dict`, within 1e-4; `t5_encode_text` end to end; and
`resample` at 24 -> 16 kHz and back within 1e-5 (float32, summation order
only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import t5 as jt5
from audiolm_pytorch_tpu.ops.resample import resample as jresample

from audiolm_pytorch_tpu_torch import T5Encoder, get_encoded_dim, resample, t5_encode_text
from audiolm_pytorch_tpu_torch.models import t5 as pt5
from audiolm_pytorch_tpu_torch.weights import t5_state_dict_from_jax

from torch_port_util import jax_named, t

SMALL = "google/t5-v1_1-small"
T5_TOL = dict(rtol=1e-4, atol=1e-4)
TEXTS = ["dog barking", "A Cat meowing in the rain", "x", "the the the"]


def _hf_state_dict(seed=1):
    """A synthetic state dict in the HF T5EncoderModel layout at SMALL's width."""
    cfg = jt5.T5_CONFIGS[SMALL]
    rng = np.random.default_rng(seed)
    d, inner, ff = cfg["dim"], cfg["heads"] * cfg["dim_head"], cfg["ff"]

    def w(*shape, scale=0.05):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    sd = {"shared.weight": w(cfg["vocab"], d, scale=1.0),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              w(32, cfg["heads"], scale=0.5),
          "encoder.final_layer_norm.weight": 1 + w(d)}
    for i in range(cfg["layers"]):
        p = f"encoder.block.{i}.layer"
        sd.update({f"{p}.0.SelfAttention.q.weight": w(inner, d),
                   f"{p}.0.SelfAttention.k.weight": w(inner, d),
                   f"{p}.0.SelfAttention.v.weight": w(inner, d),
                   f"{p}.0.SelfAttention.o.weight": w(d, inner),
                   f"{p}.0.layer_norm.weight": 1 + w(d),
                   f"{p}.1.DenseReluDense.wi_0.weight": w(ff, d),
                   f"{p}.1.DenseReluDense.wi_1.weight": w(ff, d),
                   f"{p}.1.DenseReluDense.wo.weight": w(d, ff),
                   f"{p}.1.layer_norm.weight": 1 + w(d)})
    return sd


@pytest.fixture(scope="module")
def encoders():
    """(the HF-layout state dict, JAX's small encoder loaded from it by its
    `load_torch_state_dict`, the port's with JAX's weights through the
    bridge). JAX's encoder is built by shape only (its eager random init
    and its attempt at the HF checkpoint take seconds) and stands in JAX's
    encoder cache, which `t5_encode_text` reads."""
    sd = _hf_state_dict()
    jenc = jax.eval_shape(lambda: jt5.T5Encoder(SMALL, load_pretrained=False))
    jenc.load_torch_state_dict(sd)
    penc = T5Encoder(SMALL, device="cpu").eval()
    penc.load_state_dict(t5_state_dict_from_jax(jax_named(jenc)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jt5._ENCODERS, SMALL, jenc)
        # no tokenizer files: JAX's attempt to load them takes seconds, then falls back
        mp.setattr(jt5, "_get_tokenizer", lambda name: None)
        yield sd, jenc, penc


_jax_encode = jax.jit(lambda e, i, m: e(i, m))


@pytest.mark.parametrize("max_length", [256, 3])
def test_hash_tokenizer_ids_equal_jax(max_length):
    ids, mask = pt5.tokenize_text(TEXTS, SMALL, max_length)
    jids, jmask = jt5._fallback_tokenize(TEXTS, max_length)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    assert ids.shape[1] == (min(max_length, 7))


def test_encoded_dims():
    for name, cfg in jt5.T5_CONFIGS.items():
        assert get_encoded_dim(name) == jt5.get_encoded_dim(name) == cfg["dim"]
        assert pt5.T5_CONFIGS[name] == cfg


def test_t5_encoder_matches_jax(encoders):
    _, jenc, penc = encoders
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 32128, size=(2, 8))
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    want = np.asarray(_jax_encode(jenc, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = penc(t(ids), t(mask)).numpy()
    np.testing.assert_allclose(got, want, **T5_TOL)
    assert not got[1, 5:].any() and np.abs(got[1, :5]).sum(-1).min() > 0


def test_hf_layout_state_dict_loads_as_in_jax(encoders):
    """The HF-layout state dict that JAX's `load_torch_state_dict` read, read
    by the port's: the same weights, leaf for leaf, and the same encodings."""
    sd, jenc, bridged = encoders
    penc = T5Encoder(SMALL, seed=3, device="cpu").eval()
    penc.load_torch_state_dict(sd)
    for name, a in bridged.state_dict().items():
        assert torch.equal(penc.state_dict()[name], a), name
    ids = np.random.default_rng(4).integers(0, 32128, size=(2, 6))
    mask = np.array([[True] * 6, [True] * 4 + [False] * 2])
    want = np.asarray(_jax_encode(jenc, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = penc(t(ids), t(mask)).numpy()
    np.testing.assert_allclose(got, want, **T5_TOL)


def test_t5_encode_text_matches_jax(encoders, monkeypatch):
    _, _, penc = encoders
    monkeypatch.setitem(pt5._ENCODERS, (SMALL, "cpu"), penc)
    want = np.asarray(jt5.t5_encode_text(TEXTS[:2], name=SMALL))
    got = t5_encode_text(TEXTS[:2], name=SMALL, device="cpu")
    assert got.shape == want.shape == (2, 7, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **T5_TOL)
    # the mask the LMs recover from the zeroed padding
    np.testing.assert_array_equal((got != 0).any(-1).numpy(),
                                  pt5.tokenize_text(TEXTS[:2], SMALL)[1])


@pytest.mark.parametrize("orig,new", [(24000, 16000), (16000, 24000), (44100, 16000)])
def test_resample_matches_jax(orig, new):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1201)).astype(np.float32)
    want = np.asarray(jresample(jnp.asarray(x), orig, new))
    got = resample(t(x), orig, new)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert resample(t(x), orig, orig) is not None
