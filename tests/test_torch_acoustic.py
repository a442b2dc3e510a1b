"""The port's Coarse and Fine LMs against the JAX package on the CPU: the
(H, L, L) attention biases (the Fine LM's KV-cache budget form too), logits
with and without a KV cache, both wrappers' training losses and every
parameter gradient under `jax.value_and_grad` with the JAX model on its
flash path (the Pallas kernels, the bias gradient `_dbias_kernel` among
them, in interpret mode), whole train steps with gradient accumulation
against the same loop in JAX, and greedy generation token-identical on
persist/coarse_r5.npz and persist/fine_r5.npz. Small models: dim 64, depth
2, 2 heads of 64, with 4 and 1 residual streams. Both sides get the same
numpy ids and masks.

Tolerances: 2e-3 on logits and losses; rtol 1e-2 / atol 1e-3 on gradients
(the JAX package's gradient tolerance); train steps leaf by leaf by relative
norm, the clipped gradient within 1e-2 and the update within 5e-2 at lr 1e-5,
as tests/test_torch_train.py holds the Semantic LM."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine
from audiolm_pytorch_tpu.models.transformer import KVCache as JKVCache
from audiolm_pytorch_tpu.nn.module import combine, partition_trainable
from audiolm_pytorch_tpu.training.checkpoint import load_checkpoint
from audiolm_pytorch_tpu.training.optimizer import get_optimizer as j_get_optimizer

from audiolm_pytorch_tpu_torch import (CoarseTransformer, CoarseTransformerWrapper,
                                       FineTransformer, FineTransformerWrapper, KVCache,
                                       TransformerTrainStep, load_coarse_transformer,
                                       load_fine_transformer)
from audiolm_pytorch_tpu_torch.models import wrappers as pw
from audiolm_pytorch_tpu_torch.weights import state_dict_from_jax

from torch_port_util import jax_named, jax_replace, load_into, randomize_dynamic, t

PERSIST = Path(__file__).resolve().parents[1] / "persist"
TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = dict(rtol=1e-2, atol=1e-3)
SMALL = dict(dim=64, depth=2, heads=2, dim_head=64)
COARSE = dict(SMALL, codebook_size=16, num_coarse_quantizers=3, num_semantic_tokens=20)
FINE = dict(SMALL, codebook_size=16, num_coarse_quantizers=3, num_fine_quantizers=5)


def _randomize(jm, rng):
    """Nonzero hyper-connection dynamics and learned bias scalars (the
    Coarse LM's `cross_attn_bias` is zero at init)."""
    jm = randomize_dynamic(jm, rng)
    named = jax_named(jm)
    if ".cross_attn_bias" in named:
        jm = jax_replace(jm, {".cross_attn_bias": rng.normal(size=named[".cross_attn_bias"].shape)})
    return jm


def _coarse_pair(streams, seed=0, flash=False):
    jm = JCoarse(**COARSE, num_residual_streams=streams, flash_attn=flash,
                 key=jax.random.PRNGKey(seed))
    jm = _randomize(jm, np.random.default_rng(seed))
    return jm, load_into(CoarseTransformer(**COARSE, num_residual_streams=streams,
                                           device="cpu"), jm)


def _fine_pair(streams, seed=0, flash=False):
    jm = JFine(**FINE, num_residual_streams=streams, flash_attn=flash,
               key=jax.random.PRNGKey(seed))
    jm = _randomize(jm, np.random.default_rng(seed))
    return jm, load_into(FineTransformer(**FINE, num_residual_streams=streams,
                                         device="cpu"), jm)


def _coarse_ids(rng, b, s, t_steps, q=3, cb=16, vocab=20):
    sem = rng.integers(0, vocab, size=(b, s))
    sem[-1, (2 * s) // 3:] = -1  # a padded row
    return sem, rng.integers(0, cb, size=(b, t_steps * q))


def _fine_ids(rng, b, t_steps, qc=3, qf=5, cb=16, eos=True):
    coarse = rng.integers(0, cb, size=(b, t_steps * qc))
    if eos:  # a coarse EOS (no label of the coarse head: it has cb classes) and
        coarse[0, 4] = cb
    coarse[-1, -2:] = -1  # coarse pads, both masked out of attention
    return coarse, rng.integers(0, cb, size=(b, t_steps * qf))


@pytest.mark.parametrize("sem_len,total", [(5, 12), (9, 40), (0, 7)])
def test_coarse_attn_bias_matches_jax(sem_len, total):
    jm, pm = _coarse_pair(1)
    ref = jm.build_attn_bias(sem_len, total)
    with torch.no_grad():
        out = pm.build_attn_bias(sem_len, total)
    assert out.shape == (SMALL["heads"], total, total)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# (coarse_len, fine_len): aligned and ragged time steps, no fine codes, and the
# KV-cache budget form (the whole fine budget of a generation, coarse 9 -> 15)
@pytest.mark.parametrize("coarse_len,fine_len", [(9, 15), (10, 13), (6, 0), (9, 7), (3, 25)])
def test_fine_attn_bias_matches_jax(coarse_len, fine_len):
    jm, pm = _fine_pair(1)
    ref = jm.build_attn_bias(coarse_len, fine_len)
    with torch.no_grad():
        out = pm.build_attn_bias(coarse_len, fine_len)
    assert out.shape == (SMALL["heads"], coarse_len + fine_len + 2, coarse_len + fine_len + 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("streams", [4, 1])
def test_coarse_logits_match_jax(streams):
    jm, pm = _coarse_pair(streams)
    sem, coarse = _coarse_ids(np.random.default_rng(1), 2, 14, 5)
    mask = np.random.default_rng(2).random((2, 14 + 15 + 2)) > 0.2
    mask[:, 0] = True
    ref = jm(semantic_token_ids=jnp.asarray(sem), coarse_token_ids=jnp.asarray(coarse),
             self_attn_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = pm(t(sem), t(coarse), self_attn_mask=t(mask))
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


def test_coarse_kv_cached_logits_match_jax():
    # the LM-level cache: a prefill of part of the codes, then the rest, each
    # call returning the outputs after the cache's fill position
    jm, pm = _coarse_pair(4, seed=1)
    sem, coarse = _coarse_ids(np.random.default_rng(3), 2, 10, 6)
    total = 10 + 18 + 2
    jcache = JKVCache.create(2, 2, total, 64)
    pcache = KVCache.create(2, 2, total, 64, device="cpu")
    for upto in (7, 18):
        (_, ref), jcache = jm(semantic_token_ids=jnp.asarray(sem),
                              coarse_token_ids=jnp.asarray(coarse[:, :upto]), kv_cache=jcache,
                              return_kv_cache=True)
        start = pcache.pos - 10 - 1  # the first new coarse logit
        with torch.no_grad():
            _, out = pm(t(sem), t(coarse[:, :upto]), kv_cache=pcache)
        assert pcache.pos == int(jcache.pos) == 10 + 2 + upto
        np.testing.assert_allclose(out[:, max(start, 0):].numpy(),
                                   np.asarray(ref)[:, max(start, 0):], **TOL)
    with torch.no_grad():
        _, full = pm(t(sem), t(coarse))
    np.testing.assert_allclose(out.numpy()[:, start:], full.numpy()[:, start:], **TOL)


@pytest.mark.parametrize("streams", [4, 1])
def test_fine_logits_match_jax(streams):
    jm, pm = _fine_pair(streams)
    coarse, fine = _fine_ids(np.random.default_rng(4), 2, 4)
    mask = np.random.default_rng(5).random((2, 12 + 20 + 2)) > 0.2
    mask[:, 0] = True
    ref = jm(jnp.asarray(coarse), jnp.asarray(fine), self_attn_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = pm(t(coarse), t(fine), self_attn_mask=t(mask))
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)


def test_fine_kv_cached_logits_match_jax():
    # a prefill that fills the cache: the plain attention path with the
    # materialised bias sliced at the cache's position
    jm, pm = _fine_pair(4, seed=2)
    coarse, fine = _fine_ids(np.random.default_rng(6), 2, 4)
    total = 12 + 20 + 2
    (_, ref), _ = jm(jnp.asarray(coarse), jnp.asarray(fine),
                     kv_cache=JKVCache.create(2, 2, total, 64), return_kv_cache=True)
    with torch.no_grad():
        _, out = pm(t(coarse), t(fine), kv_cache=KVCache.create(2, 2, total, 64, device="cpu"))
        _, uncached = pm(t(coarse), t(fine))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy(), uncached.numpy(), **TOL)


# --- training: loss, gradients, train steps ---

_JAX_MASK = [None]  # the mask the patched JAX draw returns while a loss is traced


def _inject_masks(monkeypatch, masks):
    """The port's forgetful masks come, in order, from the numpy `masks`;
    JAX's from `_JAX_MASK`, set by `_jax_loss_and_grads`."""
    queue = list(masks)

    def port_mask(shape, mask_prob, *, generator=None, device=None):
        m = queue.pop(0)
        assert tuple(shape) == m.shape
        return torch.from_numpy(m).to(device)

    def jax_mask(key, shape, mask_prob):
        assert tuple(shape) == _JAX_MASK[0].shape
        return _JAX_MASK[0]

    monkeypatch.setattr(pw, "generate_mask_with_prob", port_mask)
    monkeypatch.setattr(jw, "generate_mask_with_prob", jax_mask)


def _masks(rng, count, b, n, p=0.15):
    out = []
    for _ in range(count):
        m = np.ones((b, n), bool)
        for row in m:
            row[1 + rng.permutation(n - 1)[:int(n * p)]] = False
        out.append(m)
    return out


def _coarse_loss(params, rest, sem, coarse, mask):
    _JAX_MASK[0] = mask
    return jw.CoarseTransformerWrapper(transformer=combine(params, rest))(
        semantic_token_ids=sem, coarse_token_ids=coarse, return_loss=True, train=True,
        key=jax.random.PRNGKey(0))


def _fine_loss(params, rest, coarse, fine, mask):
    _JAX_MASK[0] = mask
    return jw.FineTransformerWrapper(transformer=combine(params, rest))(
        coarse_token_ids=coarse, fine_token_ids=fine, return_loss=True, train=True,
        key=jax.random.PRNGKey(0))


_JAX_VG = {"coarse": jax.jit(jax.value_and_grad(_coarse_loss)),
           "fine": jax.jit(jax.value_and_grad(_fine_loss))}


def _jax_loss_and_grads(kind, jm, a, b, mask):
    params, rest = partition_trainable(jm)
    return _JAX_VG[kind](params, rest, jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))


# (kind, the ids, the length of the mask: Coarse 1 + (S + EOS) + 1 + T*Q with
# EOS appended and the last code dropped; Fine 1 + Nc + 1 + Nf - 1)
def _training_case(kind, rng, b):
    if kind == "coarse":
        sem, coarse = _coarse_ids(rng, b, 12, 5)
        return (sem, coarse), 1 + 13 + 1 + 15
    coarse, fine = _fine_ids(rng, b, 4, eos=False)
    return (coarse, fine), 1 + 12 + 1 + 19


_PAIRS = {"coarse": (_coarse_pair, CoarseTransformerWrapper),
          "fine": (_fine_pair, FineTransformerWrapper)}


@pytest.mark.parametrize("kind,streams", [("coarse", 4), ("coarse", 1), ("fine", 4),
                                          ("fine", 1)])
def test_loss_and_every_gradient_match_jax(kind, streams, monkeypatch):
    # JAX on its flash path: the Pallas forward and fused backward, with the
    # (H, N, M) bias's gradient from `_dbias_kernel`, in interpret mode
    make, wrapper = _PAIRS[kind]
    jm, pm = make(streams, seed=5, flash=True)
    rng = np.random.default_rng(7)
    ids, n = _training_case(kind, rng, 2)
    mask, = _masks(rng, 1, 2, n)
    _inject_masks(monkeypatch, [mask])
    loss_ref, grads_ref = _jax_loss_and_grads(kind, jm, *ids, mask)
    loss = wrapper(transformer=pm)(*map(t, ids), return_loss=True, train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), **TOL)
    ref = state_dict_from_jax(jax_named(grads_ref))
    named = dict(pm.named_parameters())
    assert set(ref) == set(named)
    for name, g in ref.items():
        p = named[name]
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), g.numpy(), **GRAD_TOL, err_msg=name)
    # the learned parts of the bias get their gradient through K5's plain twin
    bias_leaves = (["cross_attn_bias", "transformer.rel_pos_bias.in_layer.weight"]
                   if kind == "coarse" else
                   ["null_pos_bias", "pos_bias_l1.weight", "pos_bias_l2.weight",
                    "pos_bias_l3.weight"])
    for name in bias_leaves:
        assert float(named[name].grad.abs().max()) > 0, name


def _above_rounding(grads):
    top = max(float(g.norm()) for g in grads.values())
    return {name for name, g in grads.items() if float(g.norm()) > 1e-6 * top}


def _assert_leaves_within(got, ref, leaves, limit, what):
    errors = {name: float((got[name] - ref[name]).norm() / ref[name].norm()) for name in leaves}
    worst = max(errors, key=errors.get)
    assert errors[worst] <= limit, f"{what}: {worst} off by {errors[worst]:.3e} > {limit}"


@pytest.mark.parametrize("kind", ["coarse", "fine"])
def test_train_steps_with_accumulation_match_jax_loop(kind, monkeypatch):
    make, wrapper = _PAIRS[kind]
    jm, pm = make(4, seed=6)
    rng = np.random.default_rng(8)
    steps, accum, b = 2, 2, 2
    batches = [_training_case(kind, rng, accum * b) for _ in range(steps)]
    n = batches[0][1]
    masks = _masks(rng, steps * accum, b, n)
    _inject_masks(monkeypatch, masks)
    lr, clip = 1e-5, 0.5
    trainer = TransformerTrainStep(wrapper(transformer=pm), lr=lr, grad_accum_every=accum,
                                   max_grad_norm=clip, device="cpu")
    tx = j_get_optimizer(lr, 0.0, max_grad_norm=clip)
    params, rest = partition_trainable(jm)
    state = tx.init(params)
    for step, (ids, _) in enumerate(batches):
        before = {name: p.detach().clone() for name, p in pm.named_parameters()}
        loss = trainer.step(*map(t, ids))
        gacc, lsum = None, 0.0
        for i in range(accum):
            micro = [a[i * b:(i + 1) * b] for a in ids]
            ref_loss, grads = _jax_loss_and_grads(kind, combine(params, rest), *micro,
                                                  masks.pop(0))
            grads = jax.tree_util.tree_map(lambda g: g / accum, grads)
            gacc = grads if gacc is None else jax.tree_util.tree_map(jnp.add, gacc, grads)
            lsum += float(ref_loss)
        assert float(optax.global_norm(gacc)) > clip  # the clip acts
        clipped, _ = optax.clip_by_global_norm(clip).update(gacc, optax.EmptyState())
        updates, state = tx.update(gacc, state, params)
        params = optax.apply_updates(params, updates)

        np.testing.assert_allclose(loss, lsum / accum, **TOL)
        named = dict(pm.named_parameters())
        ref_grads = state_dict_from_jax(jax_named(clipped))
        leaves = _above_rounding(ref_grads)
        _assert_leaves_within({k: p.grad for k, p in named.items()}, ref_grads, leaves, 1e-2,
                              f"step {step} gradient")
        _assert_leaves_within({k: p.detach() - before[k] for k, p in named.items()},
                              state_dict_from_jax(jax_named(updates)), leaves, 5e-2,
                              f"step {step} update")


# --- generation ---

@pytest.fixture(scope="module")
def r5():
    out = {}
    for kind, cls, load in (("coarse", JCoarse, load_coarse_transformer),
                            ("fine", JFine, load_fine_transformer)):
        ckpt = load_checkpoint(PERSIST / f"{kind}_r5.npz")
        jm = ckpt["restore"](cls(**ckpt["config"], key=jax.random.PRNGKey(0)))
        out[kind] = jm, load(PERSIST / f"{kind}_r5.npz", device="cpu")
    return out


def test_coarse_r5_generation_token_identical(r5):
    jm, pm = r5["coarse"]
    rng = np.random.default_rng(9)
    sem = rng.integers(0, 100, size=(2, 24))
    sem[1, 20:] = -1  # a padded row
    prime = rng.integers(0, 1024, size=(2, 6))
    kw = dict(max_time_steps=8, temperature=1e-10)
    ref = jw.CoarseTransformerWrapper(transformer=jm).generate(
        semantic_token_ids=jnp.asarray(sem), prime_coarse_token_ids=jnp.asarray(prime), **kw)
    out = CoarseTransformerWrapper(transformer=pm).generate(
        semantic_token_ids=t(sem), prime_coarse_token_ids=t(prime), **kw)
    assert out.shape == (2, 2 + 8, 3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_fine_r5_generation_token_identical(r5):
    jm, pm = r5["fine"]
    rng = np.random.default_rng(10)
    coarse = rng.integers(0, 1024, size=(2, 6, 3))
    coarse[1, -1] = -1  # a padded time step, masked out of attention
    prime = rng.integers(0, 1024, size=(2, 5))
    kw = dict(temperature=1e-10, mask_out_generated_fine_tokens=True)
    ref = jw.FineTransformerWrapper(transformer=jm).generate(
        coarse_token_ids=jnp.asarray(coarse), prime_fine_token_ids=jnp.asarray(prime), **kw)
    out = FineTransformerWrapper(transformer=pm).generate(
        coarse_token_ids=t(coarse), prime_fine_token_ids=t(prime), **kw)
    assert out.shape == (2, 6, 5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["coarse", "fine"])
def test_cached_generation_logits_match_scoring(kind):
    # each code's logits, from the cached steps, against one uncached scoring
    # of the final sequence
    if kind == "coarse":
        _, pm = _coarse_pair(4, seed=3)
        sem = torch.from_numpy(np.random.default_rng(11).integers(0, 20, size=(2, 9)))
        grid, logits = CoarseTransformerWrapper(transformer=pm, unique_consecutive=False).generate(
            semantic_token_ids=sem, max_time_steps=4, temperature=1.0, return_logits=True)
        codes = grid.reshape(2, -1)
        with torch.no_grad():
            _, full = pm(sem, codes.clamp(min=0))
        full = full[:, :codes.shape[1]]
    else:
        _, pm = _fine_pair(4, seed=3)
        coarse = torch.from_numpy(np.random.default_rng(12).integers(0, 16, size=(2, 4, 3)))
        grid, logits = FineTransformerWrapper(transformer=pm).generate(
            coarse_token_ids=coarse, temperature=1.0, return_logits=True)
        with torch.no_grad():
            _, full = pm(coarse, grid.reshape(2, -1)[:, :-1])
    # up to each row's first EOS (the coarse rows stop there)
    for row in range(2):
        n = int((grid[row].reshape(-1) >= 0).sum()) + (kind == "coarse")
        n = min(n, logits.shape[1])
        np.testing.assert_allclose(logits[row, :n].numpy(), full[row, :n].numpy(), **TOL)
