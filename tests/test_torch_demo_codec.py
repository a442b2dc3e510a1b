"""The codec of the repo's demo (`examples/train_audiolm_demo.py`: strides
(4, 4, 5), local attention of window 32 over heads of 16) in the port
against the JAX package on the CPU, with the same random weights and
codebooks carried across by `codec_state_dict_from_jax`: tokenize's codes,
the decoded waveform, and one training forward of the generator (the
total loss and its seven terms, the quantizers' draws fed from JAX's keys).
Its frames run 200 a second, so a clip of 4800 samples is 60 frames: a
window of 32 and one padded from 28, a width and a length that the card's
K7 takes since it takes every window.

JAX's quantizer takes its TPU path, the Pallas nearest-code kernel in
interpret mode (`pallas_vq`), whose formula the port's K6 follows.

Tolerances: the waveform 1e-4 (float32 through some twenty layers,
summation order only), the losses 2e-3 (the JAX package's forward
tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiolm_pytorch_tpu.models.soundstream import SoundStream as JSoundStream

from audiolm_pytorch_tpu_torch import SoundStream
from audiolm_pytorch_tpu_torch.weights import codec_state_dict_from_jax

from tests.test_torch_codec_train import (FWD, LOSS_NAMES, JaxDraws, _port_named,
                                          _random_weights, _waves, pallas_vq)  # noqa: F401
from torch_port_util import jax_replace, t

# examples/train_audiolm_demo.py's SoundStream, as the demo builds it
DEMO = dict(channels=16, strides=(4, 4, 5), channel_mults=(2, 4, 8), codebook_dim=64,
            codebook_size=256, rq_num_quantizers=8, attn_window_size=32, attn_heads=4,
            attn_dim_head=16, multi_spectral_window_powers_of_two=(6, 7),
            multi_scale_discr_kwargs=dict(channels=8, layers=3, groups=(1, 2, 4), chan_max=64))
SAMPLES = 4800  # 60 frames at 200 a second: a window of 32 and a padded one
WAVE_TOL = dict(rtol=1e-4, atol=1e-4)


def _demo_pair(seed):
    """The demo's JAX codec, built from its shapes, with random weights, and
    the port's copy of it; each quantizer's codebook filled with rows drawn
    from its residuals on random audio (as kmeans init draws its
    candidates), so that the searches spread over the codes."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: JSoundStream(**DEMO, key=jax.random.PRNGKey(seed)))
    new = _random_weights(shapes, rng, codebook_scale=1.0)
    pm = SoundStream(**DEMO, device="cpu")
    pm.load_state_dict(codec_state_dict_from_jax(new))
    with torch.no_grad():
        h = pm.encode_frames(pm.process_input(t(_waves(rng, b=4, n=SAMPLES))))
        residual = h.reshape(-1, h.shape[-1])
        for layer in pm.rq.rvqs[0].layers:
            layer.codebook.copy_(residual[t(rng.integers(0, len(residual), layer.codebook_size))])
            residual = residual - layer(residual)[0]
    new.update({k: v for k, v in _port_named(pm).items() if k.split("[<flat")[0].endswith(
        ".codebook")})
    return jax_replace(shapes, new), pm


def test_demo_codec_tokenizes_and_decodes_as_jax(pallas_vq):
    jm, pm = _demo_pair(seed=4)
    pm.eval()
    x = _waves(np.random.default_rng(4), n=SAMPLES)
    jcodes, jwave = jax.jit(lambda m, a: (lambda c: (c, m.decode_from_codebook_indices(c)))(
        m.tokenize(a)))(jm, jnp.asarray(x))
    with torch.no_grad():
        codes = pm.tokenize(t(x))
        assert codes.shape == (1, 2, 60, 8)  # (groups, batch, frames, quantizers)
        assert len(np.unique(np.asarray(jcodes)[..., 0])) > 8  # the codebooks are in use
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        wave = pm.decode_from_codebook_indices(codes)
    assert wave.shape == (2, SAMPLES)
    np.testing.assert_allclose(wave.numpy(), np.asarray(jwave), **WAVE_TOL)


def test_demo_codec_generator_loss_matches_jax(pallas_vq, monkeypatch):
    jm, pm = _demo_pair(seed=5)
    x = _waves(np.random.default_rng(5), n=SAMPLES)
    key = jax.random.PRNGKey(15)
    jtotal, jterms, _ = jax.jit(lambda m, a: m(a, key=key, train=True,
                                                return_loss_breakdown=True))(jm, jnp.asarray(x))
    draws = JaxDraws(monkeypatch)
    draws.codec(key, pm, x.shape[0] * (x.shape[1] // pm.seq_len_multiple_of))
    total, terms = pm(t(x), train=True, generator=torch.Generator(), return_loss_breakdown=True)
    assert not draws.queue
    np.testing.assert_allclose(total.item(), float(jtotal), **FWD)
    for name, got, want in zip(LOSS_NAMES, terms, np.asarray(jterms)):
        np.testing.assert_allclose(got.item(), want, **FWD, err_msg=name)
