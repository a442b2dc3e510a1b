"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (flash
forward K1, backward K2-K4) against their plain PyTorch versions, and the
Semantic LM on the card against the same weights on the CPU, in scoring and
in a train step. They skip where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu_torch import (SemanticTransformer, SemanticTransformerWrapper,
                                       TransformerTrainStep)
from audiolm_pytorch_tpu_torch.models import wrappers
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


def _counts():
    return fa.launches_dq, fa.launches_dkv, fa.launches_dtab


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-2, 1e-3),
                                             (torch.bfloat16, 3e-2, 3e-2)])
@pytest.mark.parametrize("n,causal,mqa,masked", CASES)
def test_flash_backward_kernels_match_plain_version(cuda, n, causal, mqa, masked, dtype,
                                                    rtol, atol):
    q, k, v, tab, mask = _inputs(n, mqa, masked, seed=5)
    q, k, v = (a.to(cuda, dtype) for a in (q, k, v))
    tab = tab.to(cuda)
    mask = None if mask is None else mask.to(cuda)
    kw = dict(bias_tab=tab, key_mask=mask, causal=causal)
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    g = torch.from_numpy(np.random.default_rng(6).normal(size=q.shape).astype(np.float32))
    g = g.to(cuda, dtype)
    before = _counts()
    grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, causal=causal,
                                   scale=64 ** -0.5)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before)
    ref = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, causal=causal,
                                     scale=64 ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv", "dtab"), grads, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        torch.testing.assert_close(a.float(), r.float(), rtol=rtol, atol=atol, msg=name)


def test_flash_attention_on_a_card_is_differentiable(cuda):
    # regression: the kernel's output once had no grad_fn, so no gradient
    # reached q, k, v or the table through attention
    q, k, v, tab, mask = _inputs(100, True, True, seed=7)
    q, k, v, tab = (a.to(cuda).requires_grad_() for a in (q, k, v, tab))
    mask = mask.to(cuda)
    out = fa.flash_attention(q, k, v, bias_tab=tab, key_mask=mask, causal=True)
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v, tab), g)
    qc, kc, vc, tc = (a.detach().cpu().requires_grad_() for a in (q, k, v, tab))
    ref = fa.flash_attention_ref(qc, kc, vc, bias_tab=tc, key_mask=mask.cpu(), causal=True)
    ref_grads = torch.autograd.grad(ref, (qc, kc, vc, tc), g.cpu())
    for a, r in zip(grads, ref_grads):
        torch.testing.assert_close(a.cpu(), r, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("d", [32, 128])
def test_backward_raises_on_a_cuda_tensor_it_cannot_take(cuda, d):
    q = torch.zeros(1, 2, 16, d, device=cuda)
    kv = q[:, :1].contiguous()
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, kv, kv, None, None, q, lse, q, causal=True, scale=1.0)


def _leaf_errors(got, ref, ref_grads):
    """{leaf: ||got - ref|| / ||ref||} over the leaves whose reference
    gradient is above rounding level (norm over 1e-6 of the largest leaf's;
    Adam turns the noise of the others into updates of +-lr)."""
    top = max(float(g.norm()) for g in ref_grads.values())
    return {n: float((got[n] - ref[n]).norm() / ref[n].norm())
            for n, g in ref_grads.items() if float(g.norm()) > 1e-6 * top}


def test_train_step_card_matches_cpu(cuda, monkeypatch):
    # the forgetful masks come from one CPU generator for both devices
    masks = torch.Generator().manual_seed(11)
    draw = wrappers.generate_mask_with_prob

    def cpu_drawn(shape, mask_prob, *, generator=None, device=None):
        return draw(shape, mask_prob, generator=masks).to(device)

    monkeypatch.setattr(wrappers, "generate_mask_with_prob", cpu_drawn)
    cpu = SemanticTransformer(dim=128, depth=2, heads=2, dim_head=64, num_semantic_tokens=32,
                              seed=8, device="cpu")
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith(("dyn_alpha_w", "dyn_beta_w")):
                p.normal_(0, 0.5, generator=torch.Generator().manual_seed(9))
    gpu = copy.deepcopy(cpu)
    ids = torch.from_numpy(np.random.default_rng(10).integers(0, 32, size=(2, 90)))
    runs = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        masks.manual_seed(11)
        before = _counts()
        # lr 1e-5 keeps the two trajectories within rounding of each other (see
        # tests/test_torch_train.py); the relative measures below do not shrink with lr
        step = TransformerTrainStep(SemanticTransformerWrapper(transformer=model), lr=1e-5,
                                    device=dev)
        runs[dev] = []
        for _ in range(2):
            start = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            loss = step.step(ids)
            # the clipped gradient the step applied, and the update it made
            runs[dev].append((loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
                              {n: p.detach().cpu() - start[n]
                               for n, p in model.named_parameters()}))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert _counts() == tuple(c + 2 * 2 for c in before)  # 2 layers x 2 steps
    for i, ((loss, grads, upd), (ref_loss, ref_grads, ref_upd)) in enumerate(
            zip(runs["cuda"], runs["cpu"])):
        np.testing.assert_allclose(loss, ref_loss, rtol=2e-3, atol=2e-3)
        for what, errs, limit in (("gradient", _leaf_errors(grads, ref_grads, ref_grads), 1e-2),
                                  ("update", _leaf_errors(upd, ref_upd, ref_grads), 5e-2)):
            worst = max(errs, key=errs.get)
            assert errs[worst] <= limit, f"step {i} {what}: {worst} off by {errs[worst]:.3e}"
