"""The port's text conditioning against the JAX package on the CPU, on small
models (dim 32, depth 1, and 2 for the train step, 2 heads of 16, 4
residual streams with random dynamic weights, text embeddings of width 24
projected to 32): `Attention`
over a normed context with null keys/values and as prefix self-attention;
the plain flash version's causal attention with M > N (aligned to the
bottom right) against JAX's `attend`, and JAX's Pallas kernel's top-left
alignment recorded as a divergence; the three LMs conditioned by cross
attention and by prefix, at cond_drop_prob 0 and 1, with JAX's keep mask,
and through `forward_with_cond_scale`; the loss and every gradient of a
conditioned step; the loaders and the weight bridge's cross-attention
slots.

Tolerances: 2e-3 on outputs and losses (the JAX package's forward
tolerance), rtol 1e-2 / atol 1e-3 on gradients. The JAX calls are jitted
once per module and shape (its op-by-op mode compiles every op)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine
from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
from audiolm_pytorch_tpu.models.transformer import Attention as JAttention
from audiolm_pytorch_tpu.nn.module import combine, partition_trainable
from audiolm_pytorch_tpu.ops import sampling as js
from audiolm_pytorch_tpu.ops.attention import attend as jattend
from audiolm_pytorch_tpu.ops.pallas.flash_attention import flash_attention as jflash
from audiolm_pytorch_tpu.training.checkpoint import save_checkpoint

from audiolm_pytorch_tpu_torch import (CoarseTransformer, FineTransformer, SemanticTransformer,
                                       SemanticTransformerWrapper, load_coarse_transformer,
                                       load_fine_transformer, load_semantic_transformer)
from audiolm_pytorch_tpu_torch.models import lm as plm
from audiolm_pytorch_tpu_torch.models.transformer import Attention
from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa
from audiolm_pytorch_tpu_torch.weights import lm_state_dict_to_jax, state_dict_from_jax

from torch_port_util import jax_named, jax_replace, load_into, randomize_dynamic, t

TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = dict(rtol=1e-2, atol=1e-3)
COND_DIM = 24
LM = dict(dim=32, depth=2, heads=2, dim_head=16, num_residual_streams=4, cond_dim=COND_DIM,
          has_condition=True)
KINDS = {"semantic": (JSemantic, SemanticTransformer, dict(num_semantic_tokens=20)),
         "coarse": (JCoarse, CoarseTransformer,
                    dict(num_semantic_tokens=20, codebook_size=16, num_coarse_quantizers=3)),
         "fine": (JFine, FineTransformer,
                  dict(codebook_size=16, num_coarse_quantizers=3, num_fine_quantizers=2))}
FORMS = {"cross": {}, "prefix": dict(cond_as_self_attn_prefix=True)}
LOADERS = {"semantic": load_semantic_transformer, "coarse": load_coarse_transformer,
           "fine": load_fine_transformer}


def lm_pair(jax_cls, port_cls, cfg, seed=0):
    """A JAX LM and its port with the same weights: the port's seeded
    initialisation, carried into a JAX module built by shape (JAX's own
    initialisation compiles for seconds), with random dynamic
    hyper-connection weights on both."""
    pm = port_cls(**cfg, seed=seed, device="cpu")
    shapes = jax.eval_shape(lambda: jax_cls(**cfg, key=jax.random.PRNGKey(seed)))
    jm = randomize_dynamic(jax_replace(shapes, lm_state_dict_to_jax(pm.state_dict())),
                           np.random.default_rng(seed))
    return jm, load_into(pm, jm)


def _pair(kind, form, seed=0, depth=2):
    jcls, pcls, extra = KINDS[kind]
    return lm_pair(jcls, pcls, dict(LM, **extra, **FORMS[form], depth=depth), seed)


@functools.lru_cache(maxsize=None)
def _pairs(kind, form):
    """One layer: the value residual across layers is held by the step's
    test and by generation (tests/test_torch_prompt.py), at depth 2."""
    return _pair(kind, form, depth=1)


def _text(rng, b=2, n=5):
    """text embeddings (B, L, COND_DIM) whose rows end in zero padding."""
    te = rng.normal(size=(b, n, COND_DIM)).astype(np.float32)
    te[1, 3:] = 0.0
    return te


def _ids(kind, rng, b=2):
    if kind == "semantic":
        return (rng.integers(0, 20, size=(b, 11)),)
    if kind == "coarse":
        return rng.integers(0, 20, size=(b, 6)), rng.integers(0, 16, size=(b, 9))
    return rng.integers(0, 16, size=(b, 6)), rng.integers(0, 16, size=(b, 8))


def _jax_call(kind, model, ids, **kw):
    if kind == "semantic":
        return (model(ids=ids[0], **kw),)
    if kind == "coarse":
        return model(semantic_token_ids=ids[0], coarse_token_ids=ids[1], **kw)
    return model(ids[0], ids[1], **kw)


@functools.partial(jax.jit, static_argnames=("kind",))
def _jax_logits(model, ids, te, keep, *, kind):
    """JAX's logits of one LM with the condition kept (p = 0), dropped
    (p = 1) and dropped where `keep` is False (JAX's drop: keep[:, None] &
    mask), as one batch of the three; and guidance at 3, null + (cond -
    null) * 3 of the first two, as JAX's `forward_with_cond_scale` forms it
    from its stacked batch."""
    mask = jnp.any(te != 0, axis=-1)
    masks = jnp.concatenate([mask, jnp.zeros_like(mask), keep[:, None] & mask])
    out = _jax_call(kind, model, tuple(jnp.concatenate([a] * 3) for a in ids),
                    text_embeds=jnp.concatenate([te] * 3), text_mask=masks, cond_drop_prob=0.0)
    b = te.shape[0]
    kept, dropped, drawn = ([None if o is None else o[i * b:(i + 1) * b] for o in out]
                            for i in range(3))
    cfg = [None if c is None else n + (c - n) * 3.0 for c, n in zip(kept, dropped)]
    return kept, cfg, dropped, drawn


def _port_logits(pm, ids, **kw):
    out = pm(*(t(a) for a in ids), **kw)
    return out if isinstance(out, tuple) else (out,)


def _close(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("norm_context,num_null_kv", [(True, 1), (False, 0), (True, 2)])
def test_cross_attention_matches_jax(norm_context, num_null_kv):
    rng = np.random.default_rng(0)
    kw = dict(heads=2, dim_head=16, dim_context=COND_DIM, norm_context=norm_context,
              num_null_kv=num_null_kv)
    jattn = JAttention(32, **kw, key=jax.random.PRNGKey(1))
    if norm_context:  # a non-trivial context norm
        jattn = jax_replace(jattn, {".context_norm.gamma": rng.uniform(0.5, 1.5, COND_DIM)})
    pattn = load_into(Attention(32, **kw, causal=False), jattn)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    ctx = _text(rng)
    mask = np.ones((2, 5), bool)
    mask[1, 3:] = False
    if num_null_kv:
        mask[0] = False  # a row without a context key still attends to the null keys
    vr = rng.normal(size=(2, 5, 16)).astype(np.float32)
    want, wv = jattn(jnp.asarray(x), context=jnp.asarray(ctx), mask=jnp.asarray(mask),
                     value_residual=jnp.asarray(vr), return_values=True)
    got, gv = pattn(t(x), context=t(ctx), mask=t(mask), value_residual=t(vr))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gv.detach().numpy(), np.asarray(wv), **TOL)


def test_prefix_attention_matches_jax():
    rng = np.random.default_rng(1)
    jattn = JAttention(32, heads=2, dim_head=16, causal=True, key=jax.random.PRNGKey(2))
    pattn = load_into(Attention(32, heads=2, dim_head=16), jattn)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    prefix = rng.normal(size=(2, 4, 32)).astype(np.float32)
    pmask = np.array([[True] * 4, [True, True, False, False]])
    mask = np.ones((2, 9), bool)
    mask[0, 5:7] = False
    bias = rng.normal(size=(2, 9, 9)).astype(np.float32)
    want = jattn(jnp.asarray(x), mask=jnp.asarray(mask), attn_bias=jnp.asarray(bias),
                 prefix_context=jnp.asarray(prefix), prefix_context_mask=jnp.asarray(pmask))
    got, _ = pattn(t(x), mask=t(mask), bias=t(bias), prefix_context=t(prefix),
                   prefix_context_mask=t(pmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _offset_inputs(n, m, seed=3, h=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, h, n, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, 1, m, d)).astype(np.float32) for _ in range(2))
    bias = rng.normal(size=(h, n, m)).astype(np.float32)
    g = rng.normal(size=(1, h, n, d)).astype(np.float32)
    return q, k, v, bias, g


@pytest.mark.parametrize("n,m", [(20, 28), (9, 13), (5, 70), (12, 12)])
def test_plain_flash_causal_offset_equals_jax_attend(n, m):
    """Causal attention with M >= N keys: the plain flash versions (forward
    and backward) against JAX's `attend` and its VJP, both aligned to the
    bottom right (key k seen by query q iff k <= q + M - N)."""
    q, k, v, bias, g = _offset_inputs(n, m)

    def jref(q_, k_, v_, b_):
        return jattend(q_, k_, v_, attn_bias=b_, causal=True)

    want, vjp = jax.vjp(jref, *(jnp.asarray(a) for a in (q, k, v, bias)))
    wgrads = vjp(jnp.asarray(g))
    out, lse = fa.flash_attention_ref(t(q), t(k), t(v), bias=t(bias), causal=True,
                                      return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    scale = q.shape[-1] ** -0.5
    grads = fa.flash_attention_bwd_ref(t(q), t(k), t(v), None, None, out, lse, t(g),
                                       causal=True, scale=scale, bias=t(bias))
    for got, ref in zip(grads, wgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


def test_pallas_top_left_causal_offset_is_a_recorded_divergence():
    """JAX's Pallas kernel masks k <= q for N != M (aligned to the top left)
    where JAX's own `attend` and the port take tril(M - N): at b1 h2 n20
    m28 d16 the two differ by 2.65. The port follows `attend`."""
    q, k, v, _, _ = _offset_inputs(20, 28)
    pallas = np.asarray(jflash(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                               interpret=True))
    ref = np.asarray(jattend(*(jnp.asarray(a) for a in (q, k, v)), causal=True))
    port = fa.flash_attention_ref(t(q), t(k), t(v), causal=True).numpy()
    np.testing.assert_allclose(port, ref, **TOL)
    assert np.abs(pallas - ref).max() > 1.0


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_conditioned_lm_matches_jax(kind, form, monkeypatch):
    """Logits at cond_drop_prob 0 and 1, with JAX's keep mask at 0.5, and
    through forward_with_cond_scale at 3."""
    jm, pm = _pairs(kind, form)
    rng = np.random.default_rng(4)
    ids, te = _ids(kind, rng), _text(rng)
    keep = np.array(js.prob_mask_like(jax.random.PRNGKey(6), (2,), 0.5))
    assert keep.any() and not keep.all(), "the key should keep one row and drop the other"
    want = _jax_logits(jm, tuple(jnp.asarray(a) for a in ids), jnp.asarray(te),
                       jnp.asarray(keep), kind=kind)
    monkeypatch.setattr(plm, "draw_cond_keep", lambda b, p, g, dev: torch.from_numpy(keep))
    with torch.no_grad():
        _close(_port_logits(pm, ids, text_embeds=t(te), cond_drop_prob=0.0), want[0])
        cfg = pm.forward_with_cond_scale(*(t(a) for a in ids), text_embeds=t(te), cond_scale=3.0)
        _close(cfg if isinstance(cfg, tuple) else (cfg,), want[1])
        _close(_port_logits(pm, ids, text_embeds=t(te), cond_drop_prob=1.0), want[2])
        _close(_port_logits(pm, ids, text_embeds=t(te), cond_drop_prob=0.5,
                            generator=torch.Generator()), want[3])
    # the condition reaches the logits, and the dropped rows see none of it
    te2 = _text(np.random.default_rng(99))
    with torch.no_grad():
        other = _port_logits(pm, ids, text_embeds=t(te2), cond_drop_prob=0.0)
        dropped = _port_logits(pm, ids, text_embeds=t(te2), cond_drop_prob=1.0)
    assert not np.allclose(other[-1].numpy(), np.asarray(want[0][-1]), atol=1e-3)
    _close(dropped, want[2])


def _jax_wrapper_loss(params, rest, ids, te, key):
    return jw.SemanticTransformerWrapper(transformer=combine(params, rest), mask_prob=0.0)(
        semantic_token_ids=ids, text_embeds=te, return_loss=True, train=True, key=key)


_jax_loss_grads = jax.jit(jax.value_and_grad(_jax_wrapper_loss))


@pytest.mark.parametrize("form", list(FORMS))
def test_conditioned_step_loss_and_every_gradient_match_jax(form, monkeypatch):
    """The Semantic wrapper's training loss with the condition dropped by
    JAX's keep mask (cond_drop_prob 0.5), and the gradient of every leaf."""
    jm, pm = _pair("semantic", form, seed=5)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 20, size=(4, 16))
    ids[3, 12:] = -1
    te = _text(rng, b=4)
    key = jax.random.PRNGKey(11)
    ckey = jax.random.split(key, 3)[2]  # the wrapper's split: (key, mask key, condition key)
    keep = np.array(js.prob_mask_like(ckey, (4,), 0.5))
    assert keep.any() and not keep.all()
    monkeypatch.setattr(plm, "draw_cond_keep", lambda b, p, g, dev: torch.from_numpy(keep))
    params, rest = partition_trainable(jm)
    loss_ref, grads_ref = _jax_loss_grads(params, rest, jnp.asarray(ids), jnp.asarray(te), key)
    loss = SemanticTransformerWrapper(transformer=pm, mask_prob=0.0)(
        t(ids), text_embeds=t(te), return_loss=True, train=True, generator=torch.Generator())
    pm.zero_grad()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), **TOL)
    ref = state_dict_from_jax(jax_named(grads_ref))
    named = dict(pm.named_parameters())
    assert set(ref) == set(named)
    assert any(".cross." in n for n in named) == (form == "cross")
    for name, g in ref.items():
        p = named[name]
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), g.numpy(), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_conditioned_checkpoint_loads_and_matches_jax(kind, form, tmp_path):
    """A JAX checkpoint of a conditioned LM loads through the port's loader
    (cross-attention slots, null key/value, context norm, the projection)
    and saves back to JAX's leaf names."""
    jm, _ = _pairs(kind, form)
    path = tmp_path / f"{kind}.npz"
    save_checkpoint(path, jm, config=dict(jm.configs))
    pm = LOADERS[kind](path, device="cpu")
    assert pm.has_condition and pm.transformer.cond_as_self_attn_prefix == (form == "prefix")
    assert set(lm_state_dict_to_jax(pm.state_dict())) == set(jax_named(jm))
    rng = np.random.default_rng(8)
    ids, te = _ids(kind, rng), _text(rng)
    want = _jax_logits(jm, tuple(jnp.asarray(a) for a in ids), jnp.asarray(te),
                       jnp.ones(2, bool), kind=kind)[0]
    with torch.no_grad():
        _close(_port_logits(pm, ids, text_embeds=t(te), cond_drop_prob=0.0), want)


def test_condition_must_match_the_model():
    _, pm = _pairs("semantic", "cross")
    with pytest.raises(ValueError, match="has_condition"):
        pm(torch.zeros(1, 4, dtype=torch.long))
    with pytest.raises(ValueError, match="generator"):
        pm(torch.zeros(1, 4, dtype=torch.long), text_embeds=torch.ones(1, 2, COND_DIM))
    plain = SemanticTransformer(dim=32, depth=1, heads=2, dim_head=16, num_semantic_tokens=20,
                                cond_dim=COND_DIM, device="cpu")
    with pytest.raises(ValueError, match="has_condition"):
        plain(torch.zeros(1, 4, dtype=torch.long), text_embeds=torch.ones(1, 2, COND_DIM))
