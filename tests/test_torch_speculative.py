"""The port's speculative Coarse and Fine decode (`generate(speculative=True)`)
on the CPU: token-identical to the port's sequential sampler at temperature
-> 0 (batch 1 and 2, a prompt of whole time steps, classifier-free guidance
over a [cond | uncond] batch that shares one cache), the codes and the
`spec_stats` of the JAX package's speculative sampler on the same small LMs
at greedy (and its fallback to the sequential sampler on a prompt that ends
inside a time step), valid codes at temperature 1, and the refusal under
prefix conditioning, which has no KV cache to rewind.

Models: dim 32, depth 2, 4 heads of 8, one residual stream, codebook 24, 3
coarse and 5 fine quantizers (tests/test_speculative.py's sizes); the JAX
LMs carry the port's seeded weights. Codes compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine

from audiolm_pytorch_tpu_torch import (CoarseTransformer, CoarseTransformerWrapper,
                                       FineTransformer, FineTransformerWrapper)

from test_torch_conditioning import lm_pair
from torch_port_util import t

LM = dict(dim=32, depth=2, heads=4, dim_head=8, num_residual_streams=1, codebook_size=24)
COARSE = dict(LM, num_coarse_quantizers=3, num_semantic_tokens=20)
FINE = dict(LM, num_coarse_quantizers=3, num_fine_quantizers=5)
TEXT = dict(has_condition=True, cond_dim=16)


def _wrapper(kind, seed=0, **extra):
    if kind == "coarse":
        return CoarseTransformerWrapper(
            transformer=CoarseTransformer(**COARSE, **extra, seed=seed, device="cpu"),
            unique_consecutive=False)
    return FineTransformerWrapper(transformer=FineTransformer(**FINE, **extra, seed=seed,
                                                              device="cpu"))


def _inputs(kind, rng, b, prime_steps=0):
    if kind == "coarse":
        kw = dict(semantic_token_ids=t(rng.integers(0, 20, size=(b, 6))), max_time_steps=5)
        if prime_steps:
            kw["prime_coarse_token_ids"] = t(rng.integers(0, 24, size=(b, prime_steps, 3)))
        return kw
    kw = dict(coarse_token_ids=t(rng.integers(0, 24, size=(b, 4, 3))))
    if prime_steps:
        kw["prime_fine_token_ids"] = t(rng.integers(0, 24, size=(b, prime_steps * 5)))
    return kw


@pytest.mark.parametrize("case", ["coarse-1", "coarse-2", "coarse-prime", "coarse-cfg",
                                  "fine-1", "fine-2", "fine-prime", "fine-cfg"])
def test_speculative_equals_sequential_at_greedy(case):
    kind, form = case.split("-")
    cfg = form == "cfg"
    wrapper = _wrapper(kind, seed=1, **(TEXT if cfg else {}))
    rng = np.random.default_rng(2)
    b = 1 if form == "1" else 2
    kw = _inputs(kind, rng, b, prime_steps=2 if form == "prime" else 0)
    if cfg:
        kw.update(text_embeds=t(rng.normal(size=(b, 4, 16)).astype(np.float32)), cond_scale=3.0)
    kw.update(temperature=0.0, generator=torch.Generator().manual_seed(3))
    seq = wrapper.generate(**kw)
    spec, stats = wrapper.generate(speculative=True, return_spec_stats=True, **kw)
    np.testing.assert_array_equal(spec.numpy(), seq.numpy())
    q = 3 if kind == "coarse" else 5
    assert stats["num_q"] == q and 0 < stats["steps"] <= stats["accepted"] <= q * stats["steps"]
    # the drafts were rejected somewhere, so the rewind and the tail ran
    assert stats["accepted"] < q * stats["steps"]


def _jax_generate(kind, jm, kw, **extra):
    if kind == "coarse":
        w = jw.CoarseTransformerWrapper(transformer=jm, unique_consecutive=False)
        args = dict(semantic_token_ids=jnp.asarray(kw["semantic_token_ids"].numpy()),
                    max_time_steps=kw["max_time_steps"])
        if "prime_coarse_token_ids" in kw:
            args["prime_coarse_token_ids"] = jnp.asarray(kw["prime_coarse_token_ids"].numpy())
    else:
        w = jw.FineTransformerWrapper(transformer=jm)
        args = dict(coarse_token_ids=jnp.asarray(kw["coarse_token_ids"].numpy()))
        if "prime_fine_token_ids" in kw:
            args["prime_fine_token_ids"] = jnp.asarray(kw["prime_fine_token_ids"].numpy())
    return w.generate(**args, **extra, temperature=0.0, key=jax.random.PRNGKey(0))


@pytest.mark.parametrize("case", ["coarse", "fine", "fine-unaligned"])
def test_spec_stats_and_codes_match_jax(case):
    kind = case.split("-")[0]
    jcls, pcls, cfg = (JCoarse, CoarseTransformer, COARSE) if kind == "coarse" else \
        (JFine, FineTransformer, FINE)
    jm, pm = lm_pair(jcls, pcls, cfg, seed=4)
    wrapper = CoarseTransformerWrapper(transformer=pm, unique_consecutive=False) \
        if kind == "coarse" else FineTransformerWrapper(transformer=pm)
    rng = np.random.default_rng(5)
    kw = _inputs(kind, rng, 2, prime_steps=1)
    if case == "fine-unaligned":  # a prompt that ends inside a time step: sequential
        kw["prime_fine_token_ids"] = kw["prime_fine_token_ids"][:, :3]
    got, stats = wrapper.generate(**kw, temperature=0.0, speculative=True,
                                  return_spec_stats=True)
    want, jstats = _jax_generate(kind, jm, kw, speculative=True, return_spec_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == {k: int(v) for k, v in jstats.items()}
    if case == "fine-unaligned":
        assert stats["accepted"] == stats["steps"] == 0


@pytest.mark.parametrize("kind", ["coarse", "fine"])
def test_speculative_codes_are_valid_at_temperature_one(kind):
    wrapper = _wrapper(kind, seed=6)
    kw = _inputs(kind, np.random.default_rng(7), 2)
    out, stats = wrapper.generate(**kw, temperature=1.0, speculative=True,
                                  return_spec_stats=True,
                                  generator=torch.Generator().manual_seed(8))
    q = 3 if kind == "coarse" else 5
    assert out.shape == (2, 5 if kind == "coarse" else 4, q)
    assert ((out >= -1) & (out < 25)).all() and stats["steps"] > 0


@pytest.mark.parametrize("kind", ["coarse", "fine"])
def test_speculative_refuses_prefix_conditioning(kind):
    wrapper = _wrapper(kind, seed=9, cond_as_self_attn_prefix=True, **TEXT)
    rng = np.random.default_rng(10)
    kw = _inputs(kind, rng, 1)
    te = t(rng.normal(size=(1, 4, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="prefix conditioning"):
        wrapper.generate(**kw, text_embeds=te, temperature=0.0, speculative=True)
    wrapper.generate(**kw, text_embeds=te, temperature=0.0)  # the sequential sampler runs
