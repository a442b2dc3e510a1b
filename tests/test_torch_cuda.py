"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against their
plain PyTorch versions, and the Semantic LM on the card against the same
weights on the CPU. They skip where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu_torch import SemanticTransformer, SemanticTransformerWrapper
from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa

pytestmark = pytest.mark.cuda

# (n, causal, mqa, key mask): unaligned lengths, MQA, a key mask that pads rows
CASES = [(37, True, True, True), (130, True, False, True), (64, False, True, False),
         (50, False, False, True), (1000, True, True, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, mqa, masked, *, b=2, h=8, d=64, seed=0):
    rng = np.random.default_rng(seed)
    hk = 1 if mqa else h
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in [(b, h, n, d), (b, hk, n, d), (b, hk, n, d)])
    tab = torch.from_numpy((0.5 * rng.normal(size=(2 * n - 1, h))).astype(np.float32))
    mask = None
    if masked:
        mask = torch.ones(b, n, dtype=torch.bool)
        mask[1, (2 * n) // 3:] = False
    return q, k, v, tab, mask


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("n,causal,mqa,masked", CASES)
def test_flash_kernel_matches_plain_version(cuda, n, causal, mqa, masked, dtype, tol):
    q, k, v, tab, mask = _inputs(n, mqa, masked)
    args = [a.to(cuda, dtype) for a in (q, k, v)]
    kw = dict(bias_tab=tab.to(cuda), key_mask=None if mask is None else mask.to(cuda),
              causal=causal, return_lse=True)
    before = fa.launches
    out, lse = fa.flash_attention(*args, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref, ref_lse = fa.flash_attention_ref(*args, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-3, atol=2e-3)


def test_flash_kernel_without_bias_or_mask(cuda):
    q, k, v, _, _ = _inputs(300, False, False)
    args = [a.to(cuda) for a in (q, k, v)]
    out = fa.flash_attention(*args, causal=True)
    torch.testing.assert_close(out, fa.flash_attention_ref(*args, causal=True),
                               rtol=2e-3, atol=2e-3)


def test_semantic_lm_card_matches_cpu(cuda):
    kw = dict(dim=128, depth=2, heads=4, dim_head=64, num_semantic_tokens=50, seed=3)
    gpu = SemanticTransformer(**kw, device=cuda).eval()
    cpu = SemanticTransformer(**kw, device="cpu").eval()
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 50, size=(2, 70)))
    before = fa.launches
    with torch.no_grad():
        out = gpu(ids.to(cuda))
        ref = cpu(ids)
    assert fa.launches == before + 2
    torch.testing.assert_close(out.cpu(), ref, rtol=2e-3, atol=2e-3)


def test_cached_generation_logits_match_scoring(cuda):
    tr = SemanticTransformer(dim=128, depth=2, heads=4, dim_head=64,
                             num_semantic_tokens=50, seed=4, device=cuda).eval()
    w = SemanticTransformerWrapper(transformer=tr)
    prompt = torch.arange(10, device=cuda).repeat(2, 1) + torch.tensor([[0], [20]], device=cuda)
    ids, logits = w.generate(max_length=30, prime_ids=prompt, temperature=1e-10,
                             return_logits=True)
    with torch.no_grad():
        full = tr(ids)
    # position t was sampled from ids[:, :t]; compare up to each row's first EOS
    for row in range(2):
        n = int((ids[row] >= 0).sum()) + 1
        torch.testing.assert_close(logits[row, :n], full[row, :n], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("d", [32, 48, 128])
def test_wrapper_raises_on_a_cuda_tensor_it_cannot_take(cuda, d):
    q = torch.zeros(1, 2, 16, d, device=cuda)  # the kernel is built for head dim 64 only
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous(), causal=True)
