"""The port's dropout against the JAX package on the CPU: attention dropout
(the weights after the softmax) and feed-forward dropout, forward and
backward, given JAX's keep masks; and one `TransformerTrainStep` step of each
LM (dim 32, depth 2, 2 heads of 16, 4 residual streams with random dynamic
weights; the Semantic LM cross-attending to a text condition, so the cross
attention's dropout runs too) with attn_dropout = ff_dropout = 0.1 against
JAX's loss, gradients and optax update on the same masks.

The masks: the op tests draw JAX's own `bernoulli(key, 1 - p)` and hand it to
the port's `draw_keep`. In the steps, the test process's
`jax.random.bernoulli` hands out numpy masks while JAX's step is traced,
queued in the order JAX draws them (per layer: self attention, cross
attention, feed-forward), and the port's `draw_keep` takes the same queue in
its own order, checking each shape and rate. The forgetful mask is off
(mask_prob 0) on both sides: tests/test_torch_train.py holds it.

A recorded divergence: JAX's three LMs never hand a key to their
Transformer (`models/lm.py` uses its key for the condition's dropout
alone), so a JAX LM train step drops nothing whatever attn_dropout and
ff_dropout say; the test shows that, and then gives JAX's Transformer a key
in the test process, as its own `Transformer(key=)` takes one. The port
drops in every train step, as the options say.

Tolerances: 2e-3 on outputs and losses, rtol 1e-2 / atol 1e-3 on the ops'
gradients; the steps' clipped gradient and update leaf by leaf by relative
norm (1e-2 and 5e-2), as tests/test_torch_train.py holds whole steps."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiolm_pytorch_tpu.models import transformer as jtransformer
from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine
from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
from audiolm_pytorch_tpu.nn.module import combine, partition_trainable
from audiolm_pytorch_tpu.ops.attention import attend as jattend
from audiolm_pytorch_tpu.training.optimizer import get_optimizer as j_get_optimizer

from audiolm_pytorch_tpu_torch import (CoarseTransformer, CoarseTransformerWrapper,
                                       FineTransformer, FineTransformerWrapper,
                                       SemanticTransformer, SemanticTransformerWrapper,
                                       TransformerTrainStep)
from audiolm_pytorch_tpu_torch.models.transformer import maybe_dropout
from audiolm_pytorch_tpu_torch.ops import attention as pattention
from audiolm_pytorch_tpu_torch.weights import state_dict_from_jax

from test_torch_conditioning import lm_pair
from test_torch_train import _above_rounding, _assert_leaves_within, _leaf_errors
from torch_port_util import jax_named, t

TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = dict(rtol=1e-2, atol=1e-3)
P = 0.1
LM = dict(dim=32, depth=2, heads=2, dim_head=16, num_residual_streams=4, attn_dropout=P,
          ff_dropout=P)
KINDS = {
    "semantic": (JSemantic, SemanticTransformer, SemanticTransformerWrapper,
                 dict(num_semantic_tokens=20, has_condition=True, cond_dim=24)),
    "coarse": (JCoarse, CoarseTransformer, CoarseTransformerWrapper,
               dict(num_semantic_tokens=20, codebook_size=16, num_coarse_quantizers=3)),
    "fine": (JFine, FineTransformer, FineTransformerWrapper,
             dict(codebook_size=16, num_coarse_quantizers=3, num_fine_quantizers=2))}


def _feed_port(monkeypatch, masks):
    """The port's `draw_keep` hands out `masks` ((shape, p, mask) in order)."""
    queue = list(masks)

    def draw_keep(generator, shape, p, device):
        assert queue, f"the port drew a dropout mask {tuple(shape)} beyond JAX's"
        want_shape, want_p, mask = queue.pop(0)
        assert (tuple(shape), p) == (want_shape, want_p)
        return torch.from_numpy(np.array(mask)).to(device)

    monkeypatch.setattr(pattention, "draw_keep", draw_keep)
    return queue


@pytest.mark.parametrize("where", ["attention", "feed_forward"])
def test_dropout_forward_and_backward_match_jax(where, monkeypatch):
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(3)
    g = torch.Generator()
    if where == "attention":
        q = rng.normal(size=(2, 2, 9, 16)).astype(np.float32)
        k, v = (rng.normal(size=(2, 1, 9, 16)).astype(np.float32) for _ in range(2))
        bias = rng.normal(size=(2, 9, 9)).astype(np.float32)
        mask = np.ones((2, 1, 1, 9), bool)
        mask[1, ..., 6:] = False
        inputs = (q, k, v, bias)
        keep = np.asarray(jax.random.bernoulli(key, 1 - P, (2, 2, 9, 9)))

        def jfn(q_, k_, v_, b_):
            return jattend(q_, k_, v_, mask=jnp.asarray(mask), attn_bias=b_, causal=True,
                           dropout_rate=P, dropout_key=key)

        def pfn(q_, k_, v_, b_):
            return pattention.attend(q_, k_, v_, mask=t(mask), attn_bias=b_, causal=True,
                                     dropout=P, generator=g)
    else:
        inputs = (rng.normal(size=(2, 7, 32)).astype(np.float32),)
        keep = np.asarray(jax.random.bernoulli(key, 1 - P, (2, 7, 32)))

        def jfn(x):
            return jtransformer.maybe_dropout(x, P, key)

        def pfn(x):
            return maybe_dropout(x, P, g)
    assert 0 < keep.mean() < 1
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in inputs))
    cot = rng.normal(size=want.shape).astype(np.float32)
    wgrads = vjp(jnp.asarray(cot))
    _feed_port(monkeypatch, [(keep.shape, P, keep)])
    xs = [t(a).requires_grad_() for a in inputs]
    out = pfn(*xs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(out, xs, t(cot))
    for got, ref in zip(grads, wgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


def _batch(kind, rng, b=4):
    """The wrapper's inputs, as (port positional tensors, JAX keywords)."""
    if kind == "semantic":
        ids = rng.integers(0, 20, size=(b, 12))
        te = rng.normal(size=(b, 5, 24)).astype(np.float32)
        te[1, 3:] = 0.0
        return (ids,), dict(text_embeds=te), dict(semantic_token_ids=ids, text_embeds=te)
    if kind == "coarse":
        sem, coarse = rng.integers(0, 20, size=(b, 6)), rng.integers(0, 16, size=(b, 9))
        return (sem, coarse), {}, dict(semantic_token_ids=sem, coarse_token_ids=coarse)
    coarse, fine = rng.integers(0, 16, size=(b, 6)), rng.integers(0, 16, size=(b, 8))
    return (coarse, fine), {}, dict(coarse_token_ids=coarse, fine_token_ids=fine)


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_step_with_dropout_matches_jax(kind, monkeypatch):
    jcls, pcls, wcls, extra = KINDS[kind]
    jm, pm = lm_pair(jcls, pcls, dict(LM, **extra, cond_drop_prob=0.0), seed=7)
    rng = np.random.default_rng(8)
    positional, named, jax_inputs = _batch(kind, rng)
    drawn = []
    real_bernoulli = jax.random.bernoulli

    def bernoulli(key, p, shape):
        if abs(p - (1 - P)) > 1e-9:
            return real_bernoulli(key, p, shape)
        mask = rng.random(shape) < p
        drawn.append((tuple(shape), P, mask))
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    jwcls = getattr(jw, wcls.__name__)

    def loss_fn(params, rest, inputs):
        return jwcls(transformer=combine(params, rest), mask_prob=0.0)(
            **inputs, return_loss=True, train=True, key=jax.random.PRNGKey(1))

    lr = 1e-5
    params, rest = partition_trainable(jm)
    jinputs = {k: jnp.asarray(v) for k, v in jax_inputs.items()}
    jax.jit(loss_fn).lower(params, rest, jinputs)
    assert not drawn  # JAX's LM gives its Transformer no key: no dropout
    transformer_call = jtransformer.Transformer.__call__

    def keyed(self, x, *, key=None, **kw):
        return transformer_call(self, x, key=jax.random.PRNGKey(2) if key is None else key,
                                **kw)

    monkeypatch.setattr(jtransformer.Transformer, "__call__", keyed)
    loss_ref, grads = jax.jit(jax.value_and_grad(loss_fn))(params, rest, jinputs)
    # per layer: self attention, [cross attention], feed-forward
    per_layer = 3 if kind == "semantic" else 2
    assert len(drawn) == per_layer * LM["depth"]
    tx = j_get_optimizer(lr, 0.0, max_grad_norm=0.5)

    @jax.jit
    def clip_and_update(g, p):  # one program: op by op, optax compiles each op for seconds
        return (optax.clip_by_global_norm(0.5).update(g, optax.EmptyState())[0],
                tx.update(g, tx.init(p), p)[0])

    clipped, updates = clip_and_update(grads, params)

    left = _feed_port(monkeypatch, drawn)
    step = TransformerTrainStep(wcls(transformer=pm, mask_prob=0.0), lr=lr, max_grad_norm=0.5,
                                device="cpu")
    before = {name: p.detach().clone() for name, p in pm.named_parameters()}
    loss = step.step(*(torch.from_numpy(a) for a in positional),
                     **{k: t(v) for k, v in named.items()})
    assert not left
    np.testing.assert_allclose(loss, float(loss_ref), **TOL)
    named_params = dict(pm.named_parameters())
    ref_grads = state_dict_from_jax(jax_named(clipped))
    leaves = _above_rounding(ref_grads)
    _assert_leaves_within(_leaf_errors({k: p.grad for k, p in named_params.items()},
                                       ref_grads, leaves), 1e-2, "gradient")
    _assert_leaves_within(_leaf_errors({k: p.detach() - before[k]
                                        for k, p in named_params.items()},
                                       state_dict_from_jax(jax_named(updates)), leaves),
                          5e-2, "update")


def test_eval_and_generation_take_the_flash_path(monkeypatch):
    """Without a generator nothing is dropped: scoring equals a model
    without dropout, and the uncached attention runs the flash wrapper; a
    train step (a generator) runs the plain path with the table expanded."""
    from audiolm_pytorch_tpu_torch.models import transformer as ptransformer
    cfg = dict(LM, num_semantic_tokens=20)
    with_dropout = SemanticTransformer(**cfg, device="cpu")
    without = SemanticTransformer(**dict(cfg, attn_dropout=0.0, ff_dropout=0.0), device="cpu")
    ids = torch.randint(0, 20, (2, 10), generator=torch.Generator().manual_seed(0))
    calls = []
    flash = ptransformer.flash_attention
    monkeypatch.setattr(ptransformer, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or flash(*a, **kw))
    with torch.no_grad():
        np.testing.assert_array_equal(with_dropout(ids).numpy(), without(ids).numpy())
    assert len(calls) == 2 * cfg["depth"] and all(c["bias_tab"] is not None for c in calls)
    calls.clear()
    loss = SemanticTransformerWrapper(transformer=with_dropout)(
        ids, return_loss=True, train=True, generator=torch.Generator().manual_seed(1))
    assert not calls and torch.isfinite(loss)
