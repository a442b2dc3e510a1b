"""The port's Semantic LM slice against the JAX package on the CPU: scoring
(logits and eval loss) of a small random model and of the trained
persist/semantic_r5.npz, and KV-cached generation token-identical to JAX at
temperature 1e-10. Tolerance 2e-3 on logits and loss."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
from audiolm_pytorch_tpu.models.wrappers import SemanticTransformerWrapper as JWrapper
from audiolm_pytorch_tpu.training.checkpoint import load_checkpoint

from audiolm_pytorch_tpu_torch import (SemanticTransformer, SemanticTransformerWrapper,
                                       load_semantic_transformer)

from torch_port_util import load_into, randomize_dynamic

R5 = Path(__file__).resolve().parents[1] / "persist" / "semantic_r5.npz"
TOL = dict(rtol=2e-3, atol=2e-3)


def _ids(rng, b, n, vocab):
    return rng.integers(0, vocab, size=(b, n))


@pytest.fixture(scope="module")
def small():
    kw = dict(dim=64, depth=2, heads=4, dim_head=16, num_semantic_tokens=40,
              num_residual_streams=4)
    jm = randomize_dynamic(JSemantic(**kw, key=jax.random.PRNGKey(1)), np.random.default_rng(0))
    return jm, load_into(SemanticTransformer(**kw, device="cpu"), jm)


@pytest.fixture(scope="module")
def r5():
    ckpt = load_checkpoint(R5)
    jm = ckpt["restore"](JSemantic(**ckpt["config"], key=jax.random.PRNGKey(0)))
    return jm, load_semantic_transformer(R5, device="cpu")


def _score(jm, pm, ids):
    pw = SemanticTransformerWrapper(transformer=pm)
    with torch.no_grad():
        for loss in (False, True):
            ref = jax.jit(lambda m, x: JWrapper(transformer=m)(
                semantic_token_ids=x, return_loss=loss))(jm, jnp.asarray(ids))
            out = pw(torch.from_numpy(ids), return_loss=loss)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_small_model_scoring(small):
    jm, pm = small
    ids = _ids(np.random.default_rng(1), 3, 33, 40)
    ids[1, 20:] = -1  # padded row
    _score(jm, pm, ids)


def test_small_model_kv_cached_logits_match_uncached(small):
    _, pm = small
    w = SemanticTransformerWrapper(transformer=pm)
    prompt = torch.from_numpy(np.arange(2 * 12).reshape(2, 12) % 40)
    ids, logits = w.generate(max_length=24, prime_ids=prompt, temperature=1e-10,
                             return_logits=True)
    with torch.no_grad():
        full = pm(ids)
    for row in range(2):
        n = int((ids[row] >= 0).sum()) + 1
        np.testing.assert_allclose(logits[row, :n].numpy(), full[row, :n].numpy(), **TOL)


def test_semantic_r5_scoring(r5):
    jm, pm = r5
    ids = _ids(np.random.default_rng(2), 2, 96, 100)
    _score(jm, pm, ids)


def test_semantic_r5_generation_token_identical(r5):
    jm, pm = r5
    prompt = _ids(np.random.default_rng(3), 3, 16, 100)
    prompt[2, 10:] = prompt[2, 9]  # repeats: unique-consecutive leaves a padded prompt
    ref = JWrapper(transformer=jm).generate(max_length=48, prime_ids=jnp.asarray(prompt),
                                            temperature=1e-10)
    out = SemanticTransformerWrapper(transformer=pm).generate(
        max_length=48, prime_ids=torch.from_numpy(prompt), temperature=1e-10)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SemanticTransformer(dim=32, depth=1, heads=2, num_semantic_tokens=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_semantic_transformer(R5)
