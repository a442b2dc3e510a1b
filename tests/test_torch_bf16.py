"""bf16 compute in the port against the JAX package's on the CPU.

The LM train step (`TransformerTrainStep(bf16_compute=True)`, a bfloat16
copy of every float32 parameter through `torch.func.functional_call`)
against JAX's `cast_floats` step for the Semantic LM with four
hyper-connection streams (their float32 RMS and projection), and the Coarse
and Fine LMs (their float32 position-bias MLPs feeding the flash path); the
codec with `compute_dtype="bfloat16"` (tokenize and decode); and
`SoundStreamTrainer(bf16_compute=True)`: its G step in bfloat16 and its D
step with the gradient penalty in float32, against the JAX trainer's step
functions.

bfloat16 parity is not bit parity: XLA's CPU dot and PyTorch's round their
bfloat16 outputs at different points. So bf16 losses and codec values are
held to the ROADMAP's bf16 tolerance, 3e-2 relative, and gradients by the
relative norm of the whole gradient, ||port - jax|| / ||jax||, within 5e-2.
Single leaves are not held to JAX: a leaf whose gradient is a sum that
cancels (the rel-pos MLP's, a hyper-connection's scale) is as far from
its float32 value in JAX's own bf16 run (up to 36% on these small models)
as in the port's. Instead each bf16 gradient is held to the float32 one,
which both packages agree on to 1e-5: the port's bf16 error, ||bf16 -
float32|| / ||float32||, must be nonzero (a cast happened) and at most
1.25 times JAX's (measured: 0.78, 1.12 and 1.0 times for the Semantic,
Coarse and Fine LMs). The penalty step runs in float32: bit-equal to a
float32 trainer's on the same state and batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import lm as jlm
from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.nn.module import cast_floats, combine, partition_trainable
from audiolm_pytorch_tpu.nn.module import partition_trainable_where

from audiolm_pytorch_tpu_torch import (CoarseTransformer, CoarseTransformerWrapper,
                                       FineTransformer, FineTransformerWrapper,
                                       SemanticTransformer, SemanticTransformerWrapper,
                                       SoundStreamTrainer, TransformerTrainStep)
from audiolm_pytorch_tpu_torch.models import wrappers as pw
from audiolm_pytorch_tpu_torch.weights import state_dict_from_jax

from test_torch_codec_train import (FWD, JaxDraws, _Clips, _discr_path, _port_named,
                                    _tiny_pair, _trainers, _waves, pallas_vq)  # noqa: F401
from torch_port_util import jax_named, load_into, randomize_dynamic, t

BF16_TOL = 3e-2
GRAD_BF16_TOL = 5e-2  # whole gradient, relative norm, port bf16 vs JAX bf16
BF16_ERR_RATIO = 1.25  # the port's bf16 error against float32 over JAX's
DYN_SCALE = 0.05  # the hyper-connections' dynamic weights: nonzero, not steep
SMALL = dict(dim=128, depth=2, heads=2, dim_head=64)
SEM = dict(SMALL, num_semantic_tokens=32)
COARSE = dict(SMALL, num_semantic_tokens=32, codebook_size=32, num_coarse_quantizers=3)
FINE = dict(SMALL, num_coarse_quantizers=3, num_fine_quantizers=5, codebook_size=32)


def _mask_for(shape, p=0.15):
    """A forgetful causal mask fixed by its shape, for both packages."""
    b, n = shape
    rng = np.random.default_rng(n * 1000 + b)
    m = np.ones((b, n), bool)
    for row in m:
        row[1 + rng.permutation(n - 1)[:int(n * p)]] = False
    return m


@pytest.fixture
def same_masks(monkeypatch):
    monkeypatch.setattr(pw, "generate_mask_with_prob", lambda shape, p, *, generator=None,
                        device=None: torch.from_numpy(_mask_for(tuple(shape))).to(device))
    monkeypatch.setattr(jw, "generate_mask_with_prob",
                        lambda key, shape, p: jnp.asarray(_mask_for(tuple(shape))))


def _lm_case(kind, seed=0):
    """(JAX transformer, port transformer, JAX wrapper class, port wrapper
    class, {keyword: numpy batch}, positional order of the port's step)."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    if kind == "semantic":
        jm = randomize_dynamic(jlm.SemanticTransformer(**SEM, num_residual_streams=4, key=key),
                               rng, scale=DYN_SCALE)
        pm = SemanticTransformer(**SEM, num_residual_streams=4, device="cpu")
        ids = rng.integers(0, 32, size=(2, 40))
        ids[1, 30:] = -1
        return jm, pm, jw.SemanticTransformerWrapper, SemanticTransformerWrapper, \
            {"semantic_token_ids": ids}
    if kind == "coarse":
        jm = jlm.CoarseTransformer(**COARSE, num_residual_streams=1, key=key)
        pm = CoarseTransformer(**COARSE, num_residual_streams=1, device="cpu")
        return jm, pm, jw.CoarseTransformerWrapper, CoarseTransformerWrapper, \
            {"semantic_token_ids": rng.integers(0, 32, size=(2, 12)),
             "coarse_token_ids": rng.integers(0, 32, size=(2, 36))}
    jm = jlm.FineTransformer(**FINE, num_residual_streams=1, key=key)
    pm = FineTransformer(**FINE, num_residual_streams=1, device="cpu")
    return jm, pm, jw.FineTransformerWrapper, FineTransformerWrapper, \
        {"coarse_token_ids": rng.integers(0, 32, size=(2, 24)),
         "fine_token_ids": rng.integers(0, 32, size=(2, 40))}


def _jax_loss_and_grads(jm, jwrapper, batch, bf16):
    params, rest = partition_trainable(jm)

    def loss(p):
        p = cast_floats(p, jnp.bfloat16) if bf16 else p
        return jwrapper(transformer=combine(p, rest))(
            **{k: jnp.asarray(v) for k, v in batch.items()}, return_loss=True, train=True,
            key=jax.random.PRNGKey(0))

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), state_dict_from_jax(jax_named(grads))


def _port_loss_and_grads(pm, pwrapper, batch, bf16):
    step = TransformerTrainStep(pwrapper(transformer=pm), bf16_compute=bf16, device="cpu")
    for p in step.params:
        p.grad = None
    loss = step.loss(*(t(v) for v in batch.values()))
    loss.backward()
    return loss.item(), {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                         for n, p in zip(step.names, step.params)}


def _gap(got, ref):
    """||got - ref|| / ||ref|| over all the leaves together."""
    num = sum(float((got[n] - g).square().sum()) for n, g in ref.items())
    return (num / sum(float(g.square().sum()) for g in ref.values())) ** 0.5


@pytest.mark.parametrize("kind", ["semantic", "coarse", "fine"])
def test_bf16_train_loss_and_gradients_match_jax(kind, same_masks):
    jm, pm, jwrapper, pwrapper, batch = _lm_case(kind)
    load_into(pm, jm)
    jloss, jgrads = _jax_loss_and_grads(jm, jwrapper, batch, bf16=True)
    jloss32, jgrads32 = _jax_loss_and_grads(jm, jwrapper, batch, bf16=False)
    loss, grads = _port_loss_and_grads(pm, pwrapper, batch, bf16=True)
    loss32, grads32 = _port_loss_and_grads(pm, pwrapper, batch, bf16=False)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert set(grads) == set(jgrads)
    np.testing.assert_allclose(loss, jloss, rtol=BF16_TOL)
    assert _gap(grads, jgrads) <= GRAD_BF16_TOL
    # float32: the two packages agree; bf16 departs from it, as far as JAX's does
    np.testing.assert_allclose(loss32, jloss32, rtol=2e-3)
    assert _gap(grads32, jgrads32) < 1e-4
    np.testing.assert_allclose(loss, loss32, rtol=BF16_TOL)
    err, jerr = _gap(grads, grads32), _gap(jgrads, jgrads32)
    assert 0 < err <= BF16_ERR_RATIO * jerr, (err, jerr)


def test_bf16_step_keeps_float32_masters_and_state(same_masks):
    jm, pm, _, pwrapper, batch = _lm_case("coarse", seed=1)
    step = TransformerTrainStep(pwrapper(transformer=pm), bf16_compute=True, lr=1e-3,
                                device="cpu")
    before = [p.detach().clone() for p in step.params]
    for _ in range(2):
        assert np.isfinite(step.step(*(t(v) for v in batch.values())))
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert all(v.dtype == torch.float32 for st in step.optimizer.state.values()
               for k, v in st.items() if k != "step")
    assert sum(not torch.equal(a, p) for a, p in zip(before, step.params)) > len(before) // 2


# -- the codec -------------------------------------------------------------------

def _jax_bf16_codec(seed):
    jm, pm = _tiny_pair(seed=seed, codebook_scale=0.5, compute_dtype="bfloat16")
    return jm, pm


def test_codec_bf16_tokenize_and_decode_match_jax():
    jm, pm = _jax_bf16_codec(20)
    _, pm32 = _tiny_pair(seed=20, codebook_scale=0.5)
    assert pm.compute_dtype == torch.bfloat16 and pm.config["compute_dtype"] == "bfloat16"
    x = _waves(np.random.default_rng(20), 2, 2048)
    jframes = np.asarray(jax.jit(lambda m, w: m.encode_frames(w))(jm, jnp.asarray(x)),
                         np.float32)
    with torch.no_grad():
        frames = pm.encode_frames(t(x))
        frames32 = pm32.encode_frames(t(x))
    assert frames.dtype == torch.bfloat16
    scale = np.abs(jframes).max()
    assert np.abs(frames.float().numpy() - jframes).max() / scale < BF16_TOL
    gap32 = float((frames.float() - frames32).abs().max()) / scale
    assert 0 < gap32 < BF16_TOL
    # codes of the same frames: the searches are float32 in both packages
    jcodes = np.asarray(jax.jit(lambda m, w: m.tokenize(w))(jm, jnp.asarray(x)))
    with torch.no_grad():
        codes = pm.tokenize(t(x))
    assert codes.shape == jcodes.shape
    assert (codes.numpy() == jcodes).mean() > 0.9
    # decode of the same codes
    jwave = np.asarray(jax.jit(lambda m, c: m.decode_from_codebook_indices(c))(
        jm, jnp.asarray(jcodes)), np.float32)
    with torch.no_grad():
        wave = pm.decode_from_codebook_indices(torch.from_numpy(jcodes).long())
    assert wave.dtype == torch.bfloat16
    assert np.abs(wave.float().numpy() - jwave).max() / np.abs(jwave).max() < BF16_TOL


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_codec_bf16_g_step_and_float32_penalty_step_match_jax(pallas_vq, monkeypatch, tmp_path,
                                                              compute_dtype):
    """One step with bf16_compute: JAX's `_g_step` (bfloat16) and
    `_d_step[True]` (the penalty, float32) against the port's g_step and
    d_step on the same batch and draws, for a codec computing in bfloat16
    and in float32 (the corpus recipe's: its convolutions then compute in
    float32 on the bfloat16-rounded weights)."""
    from audiolm_pytorch_tpu.nn.module import combine as jcombine
    kw = dict(rq_kwargs=dict(threshold_ema_dead_code=0.25), compute_dtype=compute_dtype)
    jm, pm = _tiny_pair(seed=21, codebook_scale=0.5, **kw)
    jtr, ptr = _trainers(tmp_path, jm, pm, bf16_compute=True, grad_accum_every=1)
    draws = JaxDraws(monkeypatch)
    keys = []
    forward = ptr.model.forward

    def drawn_forward(x, **kwargs):
        if kwargs.get("train"):
            draws.codec(keys.pop(0), ptr.model, x.shape[0] * x.shape[1] // 8)
        return forward(x, **kwargs)

    monkeypatch.setattr(ptr.model, "forward", drawn_forward)
    try:
        waves = _waves(np.random.default_rng(22))[None]  # (accum 1, B, T)
        kg, kd = jax.random.PRNGKey(210), jax.random.PRNGKey(310)
        gen, rest = partition_trainable_where(jtr.model, lambda p: not _discr_path(p))
        jtr.model, jtr.gen_opt_state, jtr.ema_state, jg, jbd = jtr._g_step(
            gen, rest, jtr.gen_opt_state, jtr.ema_state, jnp.asarray(waves), kg)
        dparams, drest = partition_trainable_where(jtr.model, _discr_path)
        new_d, jtr.discr_opt_state, jd = jtr._d_step[True](
            dparams, drest, jtr.discr_opt_state, jnp.asarray(waves), kd)
        jtr.model = jcombine(new_d, drest)
        keys += list(jax.random.split(kg, waves.shape[0]))  # one key a micro-batch
        pg, pbd = ptr.g_step(t(waves))
        assert not draws.queue and not keys
        np.testing.assert_allclose(pg.item(), float(jg), rtol=BF16_TOL)
        np.testing.assert_allclose(pbd.numpy(), np.asarray(jbd), rtol=BF16_TOL, atol=1e-4)
        assert all(p.dtype == torch.float32 for p in ptr.model.parameters())
        assert all(b.dtype in (torch.float32, torch.bool) for b in ptr.model.buffers())
        # the penalty step: float32, bit-equal to a float32 trainer's from the same state
        _, pm32 = _tiny_pair(seed=21, codebook_scale=0.5, **kw)
        pm32.load_state_dict(ptr.model.state_dict())
        ptr32 = SoundStreamTrainer(pm32, dataset=_Clips(list(waves[0])), num_train_steps=1,
                                   batch_size=2, results_folder=tmp_path / "f32",
                                   device="cpu")
        try:
            d32 = ptr32.d_step(t(waves), True)
        finally:
            ptr32.close()
        pd = ptr.d_step(t(waves), True)
        assert pd.item() == d32.item()
        np.testing.assert_allclose(pd.item(), float(jd), rtol=2 * BF16_TOL)
    finally:
        ptr.close()
        jtr.dl_iter.stop()
        jtr.valid_dl_iter.stop()
