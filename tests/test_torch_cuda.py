"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (flash
forward K1, backward K2 (with the table's gradient K4, or an (H, N, M)
bias's K5, in its launch) and K3; the codec's nearest-code search K6 and
local attention K7) against their plain PyTorch versions; K1, K2 and K3 on
the tensor cores (over MQA groups of 1 to 16 and K2 over batch sizes 1 to
9, float32 within 1e-5 of float64 where a plain-TF32 build fails, rows
whose first key tile or every key is masked, K3's dk, dv and K2's dq and
dbias the same bits every run, K5 across clusters at B = 12,
tensor-core instructions in their SASS: in K1, K2 and K3 the warpgroup
products and TMA loads (HGMMA, UTMALDG) of their Hopper design); K6 and K7
on the tensor cores (K6 one launch a search, the same bits every run, its
plain-TF32 build caught by the near-tie gate, at an unaligned base
pointer, HGMMA and UTMALDG; K7 on strided views, with masked key tiles and
rows without a key, within 1e-5 of float64 where plain TF32 fails, HMMA);
K2's and K6's launch plans as the libraries compute them; the
Semantic, Coarse and Fine LMs on the card against the same weights on the
CPU, in scoring and in train steps, and a small codec's round trip on the
card against the CPU; K1-K5 in bf16 at the stage trainers' shapes (the
table at N = 150, the (H, N, N) bias at N = 602 and 1201), K6 at their 600
tokenisation rows, and a bf16 train step whose masters stay float32; K1-K3
in text conditioning's forms (causal over M = P + N keys aligned to the
bottom right, cross attention over 17 keys and its decode step) against
the plain versions, within 1e-5 of float64 where plain TF32 fails, the
same bits every run, and a conditioned LM's logits and gradients card vs
CPU; streaming serving on the card (a small codec's streamed codes against
its `tokenize`, K6 and K7 launched once a search and once a chunk, and its
streamed waveform against its decode), the command line's tokenize ->
decode round trip with `--device cuda` from WAV and FLAC, and the native
audio loader built with g++ into build/native; the rest of the codec
family on the card against the CPU (GateLoop's scan and squeeze-excite at
16000 frames, EnCodec's and an LFQ codec's codes, K6 at EnCodec's 1200 rows
of 128); dropout's backward reusing its forward's mask, a dropout train
step on the plain path and its eval pass on K1, speculative decode equal
to the sequential sampler, and the VQ EMA's all-reduce over a one-rank
NCCL group the identity; K7 at windows 8, 32, 48 and 256 (and the demo
codec's window 32 over heads of 16), K1-K3 with a per-batch (B, H, N, M)
bias and its gradient (the same bits every run), and each kernel past the
65535 blocks a grid's y or z extent once held it to; the column-sliced form
of head dims over 128 (K1-K5 and K7 at 192, 256, 320 and 512, every bias
form, against the plain versions, float32 within 1e-5 of float64 where plain
TF32 fails, the same bits every run, HMMA in each instantiation, and every
head dim from 129 to 512 launching the kernels); bf16's K2 (every form of
the bias's gradient) and K3 at D = 256 and 192 padded to it, their Hopper
form, against the plain versions, the same bits every run, their plans as
the library computes them, HGMMA and UTMALDG; bf16's K1 at D = 256 and
192 padded to it, its Hopper rows form, in the table, (H, N, M) and per-batch
bias, prefix, cross, decode and ragged forms against the plain version, the
same bits every run, an unpadded 129-255 refused, its plan as the library
computes it, HGMMA and UTMALDG. They skip where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import copy
import re

import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu_torch import (CoarseTransformer, CoarseTransformerWrapper,
                                       FineTransformer, FineTransformerWrapper,
                                       SemanticTransformer, SemanticTransformerWrapper,
                                       SoundStream, TransformerTrainStep)
from audiolm_pytorch_tpu_torch.models import wrappers
from audiolm_pytorch_tpu_torch.ops.kernels import _build
from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa
from audiolm_pytorch_tpu_torch.ops.kernels import local_attention as la
from audiolm_pytorch_tpu_torch.ops.kernels import vq

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


@pytest.mark.parametrize("d", [160, 512])
def test_wrapper_raises_on_a_cuda_tensor_it_cannot_take(cuda, d):
    # head dims over 128 were refused on the card; now the column-sliced form
    # takes them (160 zero-padded to 192): K1 launches and agrees with the
    # plain version. A head dim under 1 is still refused.
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.normal(size=(1, 2, 70, d)).astype(np.float32)).to(cuda)
    kv = q[:, :1].contiguous()
    before = fa.launches
    out = fa.flash_attention(q, kv, kv, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and out.shape == q.shape
    torch.testing.assert_close(out, fa.flash_attention_ref(q, kv, kv, causal=True),
                               rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="1 and more"):
        fa.native_head_dim(0)


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


@pytest.mark.parametrize("d", [160, 512])
def test_backward_raises_on_a_cuda_tensor_it_cannot_take(cuda, d):
    # head dims over 128 were refused on the card; now K2 and K3 launch in
    # their column-sliced form (160 zero-padded to 192) and agree with the
    # plain backward
    rng = np.random.default_rng(d + 1)
    q, g = (torch.from_numpy(rng.normal(size=(1, 2, 70, d)).astype(np.float32)).to(cuda)
            for _ in range(2))
    kv = q[:, :1].contiguous()
    out, lse = fa.flash_attention(q, kv, kv, causal=True, return_lse=True)
    before = fa.launches_dq, fa.launches_dkv
    grads = fa.flash_attention_bwd(q, kv, kv, None, None, out, lse, g, causal=True,
                                   scale=d ** -0.5)
    torch.cuda.synchronize()
    assert (fa.launches_dq, fa.launches_dkv) == (before[0] + 1, before[1] + 1)
    ref = fa.flash_attention_bwd_ref(q, kv, kv, None, None, out, lse, g, causal=True,
                                     scale=d ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert a.shape == r.shape, name
        torch.testing.assert_close(a, r, rtol=1e-2, atol=1e-3, msg=name)


def _leaf_errors(got, ref, ref_grads):
    """{leaf: ||got - ref|| / ||ref||} over the leaves whose reference
    gradient is above rounding level (norm over 1e-6 of the largest leaf's;
    Adam turns the noise of the others into updates of +-lr)."""
    top = max(float(g.norm()) for g in ref_grads.values())
    return {n: float((got[n] - ref[n]).norm() / ref[n].norm())
            for n, g in ref_grads.items() if float(g.norm()) > 1e-6 * top}


def _randomize_dynamic(model):
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("dyn_alpha_w", "dyn_beta_w", "cross_attn_bias")):
                p.normal_(0, 0.5, generator=torch.Generator().manual_seed(9))
    return model


def _card_vs_cpu_train_steps(monkeypatch, cpu, wrapper, batch, launches_per_step):
    """Two train steps of `cpu` and of its copy on the card on the same
    batch and forgetful masks: the losses, and each step's clipped gradient
    and update leaf by leaf by relative norm."""
    # the forgetful masks come from one CPU generator for both devices
    masks = torch.Generator().manual_seed(11)
    draw = wrappers.generate_mask_with_prob

    def cpu_drawn(shape, mask_prob, *, generator=None, device=None):
        return draw(shape, mask_prob, generator=masks).to(device)

    monkeypatch.setattr(wrappers, "generate_mask_with_prob", cpu_drawn)
    gpu = copy.deepcopy(cpu)
    runs = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        masks.manual_seed(11)
        before = _counts() + (fa.launches_dbias,)
        # lr 1e-5 keeps the two trajectories within rounding of each other (see
        # tests/test_torch_train.py); the relative measures below do not shrink with lr
        step = TransformerTrainStep(wrapper(transformer=model), lr=1e-5, device=dev)
        runs[dev] = []
        for _ in range(2):
            start = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            loss = step.step(*batch)
            # the clipped gradient the step applied, and the update it made
            runs[dev].append((loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
                              {n: p.detach().cpu() - start[n]
                               for n, p in model.named_parameters()}))
        if dev == "cuda":
            torch.cuda.synchronize()
            after = _counts() + (fa.launches_dbias,)
            assert tuple(a - c for a, c in zip(after, before)) == launches_per_step(2)
    for i, ((loss, grads, upd), (ref_loss, ref_grads, ref_upd)) in enumerate(
            zip(runs["cuda"], runs["cpu"])):
        np.testing.assert_allclose(loss, ref_loss, rtol=2e-3, atol=2e-3)
        for what, errs, limit in (("gradient", _leaf_errors(grads, ref_grads, ref_grads), 1e-2),
                                  ("update", _leaf_errors(upd, ref_upd, ref_grads), 5e-2)):
            worst = max(errs, key=errs.get)
            assert errs[worst] <= limit, f"step {i} {what}: {worst} off by {errs[worst]:.3e}"


def test_train_step_card_matches_cpu(cuda, monkeypatch):
    cpu = _randomize_dynamic(SemanticTransformer(dim=128, depth=2, heads=2, dim_head=64,
                                                 num_semantic_tokens=32, seed=8, device="cpu"))
    ids = torch.from_numpy(np.random.default_rng(10).integers(0, 32, size=(2, 90)))
    # 2 layers x 2 steps of K2 with K4 and K3; no K5
    _card_vs_cpu_train_steps(monkeypatch, cpu, SemanticTransformerWrapper, (ids,),
                             lambda steps: (2 * steps,) * 3 + (0,))


ACOUSTIC = dict(dim=128, depth=2, heads=2, dim_head=64, codebook_size=32,
                num_coarse_quantizers=3)


def _acoustic(kind, seed=8):
    if kind == "coarse":
        model = CoarseTransformer(**ACOUSTIC, num_semantic_tokens=40, seed=seed, device="cpu")
        rng = np.random.default_rng(10)
        batch = (torch.from_numpy(rng.integers(0, 40, size=(2, 30))),
                 torch.from_numpy(rng.integers(0, 32, size=(2, 45))))
        return model, CoarseTransformerWrapper, batch
    model = FineTransformer(**ACOUSTIC, num_fine_quantizers=5, seed=seed, device="cpu")
    rng = np.random.default_rng(10)
    batch = (torch.from_numpy(rng.integers(0, 32, size=(2, 45))),
             torch.from_numpy(rng.integers(0, 32, size=(2, 75))))
    return model, FineTransformerWrapper, batch


@pytest.mark.parametrize("kind", ["coarse", "fine"])
def test_acoustic_train_step_card_matches_cpu(cuda, monkeypatch, kind):
    model, wrapper, batch = _acoustic(kind)
    # 2 layers x 2 steps of K2 (each carrying K5) and K3; no K4 (no table)
    _card_vs_cpu_train_steps(monkeypatch, _randomize_dynamic(model), wrapper, batch,
                             lambda steps: (2 * steps, 2 * steps, 0, 2 * steps))


@pytest.mark.parametrize("dtype,tol,rtol,atol", [(torch.float32, 2e-3, 1e-2, 1e-3),
                                                 (torch.bfloat16, 3e-2, 3e-2, 3e-2)])
@pytest.mark.parametrize("n,causal,mqa,masked", CASES)
def test_flash_bias_kernels_match_plain_version(cuda, n, causal, mqa, masked, dtype, tol,
                                                rtol, atol):
    q, k, v, _, mask = _inputs(n, mqa, masked, seed=12)
    q, k, v = (a.to(cuda, dtype) for a in (q, k, v))
    bias = torch.from_numpy(np.random.default_rng(13).normal(size=(8, n, n)).astype(np.float32))
    bias = 0.5 * bias.to(cuda)
    mask = None if mask is None else mask.to(cuda)
    kw = dict(bias=bias, key_mask=mask, causal=causal)
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-3, atol=2e-3)
    g = torch.from_numpy(np.random.default_rng(14).normal(size=q.shape).astype(np.float32))
    g = g.to(cuda, dtype)
    before = _counts() + (fa.launches_dbias,)
    grads = fa.flash_attention_bwd(q, k, v, None, mask, out, lse, g, bias=bias, causal=causal,
                                   scale=64 ** -0.5)
    torch.cuda.synchronize()
    # K2 and K3 once each, K2 carrying K5; no K4
    assert _counts() + (fa.launches_dbias,) == (before[0] + 1, before[1] + 1, before[2],
                                                before[3] + 1)
    ref = fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g, bias=bias,
                                     causal=causal, scale=64 ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        torch.testing.assert_close(a.float(), r.float(), rtol=rtol, atol=atol, msg=name)


def test_per_batch_bias_raises_on_a_cuda_tensor(cuda):
    # a per-batch (B, H, N, M) bias was refused on the card; now K1-K3 take it,
    # through autograd, as the plain version does
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 2, 16, 64)).astype(np.float32)).to(cuda)
    kv = q[:, :1].contiguous()
    bias = torch.from_numpy(rng.normal(size=(2, 2, 16, 16)).astype(np.float32)).to(cuda)
    leaves = [a.clone().requires_grad_() for a in (q, kv, kv, bias)]
    out = fa.flash_attention(*leaves[:3], bias=leaves[3], causal=True)
    grads = torch.autograd.grad(out.square().sum(), leaves)
    cpu = [a.detach().cpu().requires_grad_() for a in leaves]
    ref = fa.flash_attention_ref(*cpu[:3], bias=cpu[3], causal=True)
    want = torch.autograd.grad(ref.square().sum(), cpu)
    torch.testing.assert_close(out.cpu(), ref, rtol=2e-3, atol=2e-3)
    for a, r in zip(grads, want):
        torch.testing.assert_close(a.cpu(), r, rtol=1e-2, atol=1e-3)
    # a head dim over 128 was refused here too; now the column-sliced form
    # takes it with the per-batch bias, through autograd
    wide = torch.from_numpy(rng.normal(size=(2, 2, 16, 160)).astype(np.float32)).to(cuda)
    leaves = [a.clone().requires_grad_() for a in (wide, wide[:, :1], wide[:, :1], bias)]
    out = fa.flash_attention(*leaves[:3], bias=leaves[3], causal=True)
    grads = torch.autograd.grad(out.square().sum(), leaves)
    cpu = [a.detach().cpu().requires_grad_() for a in leaves]
    ref = fa.flash_attention_ref(*cpu[:3], bias=cpu[3], causal=True)
    want = torch.autograd.grad(ref.square().sum(), cpu)
    torch.testing.assert_close(out.cpu(), ref, rtol=2e-3, atol=2e-3)
    for a, r in zip(grads, want):
        torch.testing.assert_close(a.cpu(), r, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("kind", ["coarse", "fine"])
def test_bias_gradient_reaches_the_learned_bias_on_the_card(cuda, kind):
    # K2's dbias (K5) flows through torch.where (and the Fine LM's gather) into the
    # learned parts of the bias, as on the CPU
    model, wrapper, batch = _acoustic(kind, seed=15)
    model = _randomize_dynamic(model)
    grads = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(dev)
        wrapper(transformer=m)(*(a.to(dev) for a in batch), return_loss=True).backward()
        grads[dev] = {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None}
    leaves = (["cross_attn_bias", "transformer.rel_pos_bias.in_layer.weight",
               "transformer.rel_pos_bias.out_layer.weight"] if kind == "coarse" else
              ["null_pos_bias", "pos_bias_l1.weight", "pos_bias_l2.weight", "pos_bias_l3.weight"])
    for name in leaves:
        card, cpu = grads["cuda"][name], grads["cpu"][name]
        assert float(card.abs().max()) > 0, name
        assert float((card - cpu).norm() / cpu.norm()) < 1e-3, name


def _vq_inputs(n, c, d, seed=0):
    """Rows near random codes (30% far from any) and a codebook whose rows
    1, c // 2 and c - 1 copy row 0, x[0] near row c // 2: a four-way tie."""
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(c, d)).astype(np.float32)
    cb[[1, c // 2, c - 1]] = cb[0]
    near = rng.integers(0, c, size=n)
    near[0] = c // 2
    x = cb[near] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    far = rng.random(n) < 0.3
    far[0] = False
    x[far] = rng.normal(size=(int(far.sum()), d)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(cb)


# C under one tile of 128 codes (100, 64: a cluster of one), 3 tiles (a
# cluster of 3), 9 tiles (rank 0 takes two); D not a multiple of 8 or 32;
# EnCodec's search (8 x 2 s at 75 Hz against 1024 codes of 128)
@pytest.mark.parametrize("n,c,d", [(1, 1024, 512), (7, 1024, 512), (800, 1024, 512),
                                   (1300, 1024, 512), (600, 1024, 512), (37, 100, 33),
                                   (130, 64, 16), (1200, 1024, 128),
                                   (50, 300, 64), (20, 1100, 40), (65, 1024, 30)])
def test_vq_kernel_matches_plain_version(cuda, n, c, d):
    x, cb = (a.to(cuda) for a in _vq_inputs(n, c, d))
    before = vq.launches
    got = vq.vq_nearest_code(x, cb)
    torch.cuda.synchronize()
    assert vq.launches == before + 1 and got.dtype == torch.int32
    ref = vq.vq_nearest_code_ref(x, cb)
    assert got[0].item() == 0  # the first of the four equal codes
    # identical, but where the float64 scores of the two picks differ by
    # under 1e-5 of the score's terms (the kernel sums in another order)
    rows = (got != ref).nonzero().flatten()
    if len(rows):
        xd = x[rows].double()

        def score(pick):
            e = cb.double()[pick[rows].long()]
            e2 = e.square().sum(-1)
            return e2 - 2 * (xd * e).sum(-1), e2 + 2 * xd.norm(dim=-1) * e.norm(dim=-1)

        (s_got, size), (s_ref, _) = score(got), score(ref)
        assert ((s_got - s_ref).abs() / size).max() < 1e-5


def test_vq_kernel_gives_ties_the_first_index(cuda):
    x = torch.randn(9, 64, device=cuda)
    for cb in (torch.zeros(300, 64, device=cuda), torch.ones(300, 64, device=cuda)):
        assert (vq.vq_nearest_code(x, cb) == vq.vq_nearest_code_ref(x, cb)).all()
    assert (vq.vq_nearest_code(x, torch.zeros(300, 64, device=cuda)) == 0).all()


def test_vq_kernel_gives_the_same_bits_every_run(cuda):
    x, cb = (a.to(cuda) for a in _vq_inputs(800, 1024, 512, seed=4))
    first = vq.vq_nearest_code(x, cb)
    for _ in range(2):
        assert torch.equal(vq.vq_nearest_code(x, cb), first)


def test_vq_search_is_one_device_launch(cuda):
    # no |e|^2 op, init or unpack kernel around the search
    x, cb = (a.to(cuda) for a in _vq_inputs(800, 1024, 512))
    vq.vq_nearest_code(x, cb)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            vq.vq_nearest_code(x, cb)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}
    assert len(kernels) == 1 and "vq_nearest_kernel" in next(iter(kernels)), kernels
    assert next(iter(kernels.values())) == 3, kernels


def _near_ties(n, c, d, seed=0):
    """Each row near the midpoint of two random codes a and b, moved along
    a - b until their float64 scores differ by 1.5e-5 to 4e-5 of the score's
    terms (either one lower); every other code far."""
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(c, d)).astype(np.float32)
    a = rng.integers(0, c, size=n)
    b = (a + rng.integers(1, c, size=n)) % c
    ea, eb = cb[a].astype(np.float64), cb[b].astype(np.float64)
    x0 = (ea + eb) / 2 + 0.3 * rng.normal(size=(n, d))
    diff = ea - eb
    size = (ea * ea).sum(-1) + 2 * np.linalg.norm(x0, axis=-1) * np.linalg.norm(ea, axis=-1)
    gap = rng.uniform(1.5e-5, 4e-5, size=n) * size * rng.choice([-1.0, 1.0], size=n)
    shift = ((ea * ea).sum(-1) - (eb * eb).sum(-1) - 2 * (x0 * diff).sum(-1) - gap) \
        / (2 * (diff * diff).sum(-1))
    return torch.from_numpy((x0 + shift[:, None] * diff).astype(np.float32)), torch.from_numpy(cb)


def _far_picks(cuda):
    """Rows where K6 picks another code than its plain version, and how far
    apart the float64 scores of the two picks are (share of the terms), at
    the codec's shape with every row a near tie."""
    x, cb = (a.to(cuda) for a in _near_ties(800, 1024, 512))
    got, ref = vq.vq_nearest_code(x, cb), vq.vq_nearest_code_ref(x, cb)
    rows = (got != ref).nonzero().flatten()
    xd = x[rows].double()

    def score(pick):
        e = cb.double()[pick[rows].long()]
        return (e.square().sum(-1) - 2 * (xd * e).sum(-1),
                e.square().sum(-1) + 2 * xd.norm(dim=-1) * e.norm(dim=-1))

    (s_got, size), (s_ref, _) = score(got), score(ref)
    return ((s_got - s_ref).abs() / size).tolist()


def test_vq_kernel_picks_the_plain_versions_codes_at_near_ties(cuda):
    assert all(gap < 1e-5 for gap in _far_picks(cuda))


def test_plain_tf32_build_of_k6_fails_the_near_tie_gate(cuda):
    # the products without the small terms (plain TF32) err by ~1e-5 of the terms
    with _build.built_with(("MMA_TF32_ONE_PASS",)):
        gaps = _far_picks(cuda)
    assert max(gaps, default=0.0) >= 1e-5, gaps


def _local_inputs(b, h, t, w, masked, biased, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, t, 64)).astype(np.float32))
               for _ in range(3))
    mask = bias = None
    if masked:
        mask = torch.ones(b, t, dtype=torch.bool)
        mask[0, :4] = False  # queries 0-3 of window 0 without a key
        mask[-1, (2 * t) // 3:] = False
    if biased:
        bias = torch.from_numpy((0.3 * rng.normal(size=(h, w, 2 * w))).astype(np.float32))
    return q, k, v, mask, bias


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,t,w,masked,biased", [(8, 100, 128, False, False),
                                                 (8, 500, 128, False, False),
                                                 (2, 300, 64, True, True),
                                                 (2, 64, 64, True, False),
                                                 (1, 129, 128, False, True)])
def test_local_attention_kernel_matches_plain_version(cuda, b, t, w, masked, biased, dtype, tol):
    q, k, v, mask, bias = _local_inputs(b, 8, t, w, masked, biased)
    q, k, v = (a.to(cuda, dtype) for a in (q, k, v))
    kw = dict(window_size=w, mask=None if mask is None else mask.to(cuda),
              attn_bias=None if bias is None else bias.to(cuda), scale=8 / 64)
    before = la.launches
    out = la.local_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert la.launches == before + 1 and out.dtype == dtype
    torch.testing.assert_close(out.float(), la.local_attention_ref(q, k, v, **kw).float(),
                               rtol=tol, atol=tol)


def _strided_local(b, h, t, dtype, cuda, seed=1):
    """q, k, v as LocalMHA hands them over: (B, H, T, D) views of chunks of
    one (B, T, 3 H D) projection."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * 64)).astype(np.float32))
    return [a.reshape(b, t, h, 64).transpose(1, 2)
            for a in qkv.to(cuda, dtype).chunk(3, dim=-1)]


# whole key tiles masked: keys 0-69 of row 0 (window 0's first tile, so its
# queries 0-69 have no key), and in row 1 keys 64-191 at w 64 (windows 1 and
# 2: window 2's queries have no key) or 0-255 at w 128 (windows 0 and 1: no
# query of theirs has a key)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("t,w", [(300, 64), (200, 64), (300, 128), (129, 128), (256, 128)])
def test_local_attention_kernel_on_strided_views_and_masked_tiles(cuda, t, w, dtype, tol):
    q, k, v = _strided_local(2, 8, t, dtype, cuda)
    assert all(la._readable(a) is a for a in (q, k, v))  # no copy on the way in
    mask = torch.ones(2, t, dtype=torch.bool, device=cuda)
    mask[0, :70] = False
    mask[1, 64:192] = False
    if w == 128:
        mask[1, :256] = False
    bias = torch.from_numpy((0.3 * np.random.default_rng(2).normal(size=(8, w, 2 * w)))
                            .astype(np.float32)).to(cuda)
    for kw in (dict(mask=mask), dict(mask=mask, attn_bias=bias), {}):
        out = la.local_attention(q, k, v, window_size=w, scale=8 / 64, **kw)
        ref = la.local_attention_ref(q, k, v, window_size=w, scale=8 / 64, **kw)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    # a row without a key: the mean of the window's 2w value slots
    out = la.local_attention(q, k, v, window_size=w, mask=mask)
    torch.testing.assert_close(out[0, :, 0].float(), v[0, :, :w].float().sum(1) / (2 * w),
                               rtol=tol, atol=tol)


def _k7_f64_error(cuda, t, w, masked):
    q, k, v, mask, bias = _local_inputs(2, 8, t, w, masked, True, seed=6)
    q, k, v, bias = (a.to(cuda) for a in (q, k, v, bias))
    kw = dict(window_size=w, mask=None if mask is None else mask.to(cuda), scale=8 / 64)
    ref = la.local_attention_ref(q.double(), k.double(), v.double(), attn_bias=bias.double(),
                                 **kw)
    out = la.local_attention(q, k, v, attn_bias=bias, **kw)
    return float((out.double() - ref).abs().max() / ref.abs().max())


K7_F64_CASES = [(300, 64, True), (500, 128, False)]


@pytest.mark.parametrize("t,w,masked", K7_F64_CASES)
def test_fp32_k7_holds_float64_to_1e5(cuda, t, w, masked):
    assert _k7_f64_error(cuda, t, w, masked) <= 1e-5


@pytest.mark.parametrize("t,w,masked", K7_F64_CASES)
def test_plain_tf32_build_fails_the_k7_float64_check(cuda, t, w, masked):
    with _build.built_with(("MMA_TF32_ONE_PASS",)):
        assert _k7_f64_error(cuda, t, w, masked) > 1e-5


def test_k6_and_k7_issue_tensor_core_instructions(cuda):
    # K6: warpgroup products (HGMMA) fed by TMA loads (UTMALDG); K7: mma.sync (HMMA)
    found = {}
    for src, kernel, ops_needed in ((vq.SOURCE, "vq_nearest_kernel", ("HGMMA", "UTMALDG")),
                                    (la.SOURCE, "local_attn_kernel", ("HMMA",))):
        for mangled, ops in _build.sass_counts(src).items():
            if kernel in mangled:
                found[kernel, "bf16" if "bfloat16" in mangled else "fp32"] = [
                    ops[op] for op in ops_needed]
    assert sorted(found) == [("local_attn_kernel", "bf16"), ("local_attn_kernel", "fp32"),
                             ("vq_nearest_kernel", "fp32")], found
    assert all(all(counts) for counts in found.values()), found


def test_vq_kernel_at_an_unaligned_base_pointer(cuda):
    # slices of larger buffers, 4 bytes past a 16-byte boundary: the wrapper
    # hands the kernel 16-byte aligned copies (TMA's rule)
    x, cb = _vq_inputs(300, 1024, 512, seed=5)
    xb, cbb = torch.zeros(x.numel() + 1, device=cuda), torch.zeros(cb.numel() + 1, device=cuda)
    xb[1:] = x.flatten().to(cuda)
    cbb[1:] = cb.flatten().to(cuda)
    xs, cbs = xb[1:].view(300, 512), cbb[1:].view(1024, 512)
    assert xs.data_ptr() % 16 and cbs.data_ptr() % 16
    got = vq.vq_nearest_code(xs, cbs)
    assert torch.equal(got, vq.vq_nearest_code(xs.clone(), cbs.clone()))
    assert (got == vq.vq_nearest_code_ref(xs, cbs)).float().mean() > 0.99
    assert got[0].item() == 0


def test_k2_and_k6_plans_match_the_librarys(cuda):
    for n, c, d in ((1, 1024, 512), (7, 1024, 512), (192, 1024, 512), (800, 1024, 512),
                    (1300, 1024, 512), (1200, 1024, 128), (37, 100, 36), (65, 1024, 32)):
        plan = vq.vq_plan(n, c, d)
        assert vq.vq_plan_built(n, c, d) == (plan["ksplit"], plan["groups"]), (n, c, d)
    for b, h, hk, n, m in ((4, 8, 1, 2049, 2049), (4, 4, 4, 602, 602), (4, 8, 1, 2049, 17),
                           (2, 4, 1, 2049, 2049), (9, 8, 8, 130, 130), (12, 8, 1, 100, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            for d in fa.HEAD_DIMS:
                for dbias in (False, True):
                    plan = fa.dq_plan(b, h, hk, n, m, True, dtype, dbias=dbias, d=d)
                    assert fa.dq_plan_built(b, h, hk, n, m, dtype, dbias=dbias, d=d) == (
                        plan["cluster"], plan["stages"], plan["smem"], plan["blocks"]), (
                        b, h, n, m, d, dtype)


def test_local_attention_on_a_card_is_differentiable(cuda):
    q, k, v, mask, bias = _local_inputs(2, 8, 300, 64, True, True, seed=3)
    leaves = [a.to(cuda).requires_grad_() for a in (q, k, v, bias)]
    out = la.local_attention(*leaves[:3], window_size=64, mask=mask.to(cuda),
                             attn_bias=leaves[3])
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, leaves, g)
    cpu = [a.detach().cpu().requires_grad_() for a in leaves]
    ref = la.local_attention_ref(*cpu[:3], window_size=64, mask=mask, attn_bias=cpu[3])
    for a, r in zip(grads, torch.autograd.grad(ref, cpu, g.cpu())):
        torch.testing.assert_close(a.cpu(), r, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("w,d", [(32, 64), (256, 64), (128, 160), (64, 256), (32, 512)])
def test_local_attention_raises_on_a_cuda_tensor_it_cannot_take(cuda, w, d):
    # windows 32 and 256, then head dims over 128, were refused on the card;
    # now K7 takes every window and head dim (160 zero-padded to 192)
    q = torch.from_numpy(np.random.default_rng(w + d).normal(size=(1, 2, 100, d))
                         .astype(np.float32)).to(cuda)
    before = la.launches
    out = la.local_attention(q, q, q, window_size=w)
    assert la.launches == before + 1
    torch.testing.assert_close(out, la.local_attention_ref(q, q, q, window_size=w),
                               rtol=2e-3, atol=2e-3)


def test_codec_round_trip_card_matches_cpu(cuda):
    kw = dict(channels=8, strides=(2, 4, 5), channel_mults=(2, 4, 8), codebook_dim=128,
              codebook_size=256, rq_num_quantizers=4, attn_window_size=64, attn_heads=2,
              attn_dim_head=64, seed=4)
    cpu = SoundStream(**kw, device="cpu").eval()
    x = torch.from_numpy(0.1 * np.random.default_rng(4).normal(size=(2, 8000)).astype(np.float32))
    with torch.no_grad():
        h = cpu.encode_frames(x).reshape(-1, 128)  # 400 frames
        gen = torch.Generator().manual_seed(4)
        for i, layer in enumerate(cpu.rq.rvqs[0].layers):  # codebooks drawn from the frames
            layer.codebook.copy_(h[torch.randperm(h.shape[0], generator=gen)[:256]] * 0.5 ** i)
        card = copy.deepcopy(cpu).to(cuda)
        before = vq.launches, la.launches
        codes = card.tokenize(x.to(cuda))
        wave = card.decode_from_codebook_indices(codes)
        torch.cuda.synchronize()
        assert (vq.launches, la.launches) == (before[0] + 4, before[1] + 2)
        cpu_codes = cpu.tokenize(x)
        assert (codes.cpu() != cpu_codes).any(-1).float().mean() <= 0.02
        ref = cpu.decode_from_codebook_indices(codes.cpu())
        assert float((wave.cpu() - ref).abs().max() / ref.abs().max()) < 1e-4


# K1 and K3 on the tensor cores (bf16 mma, float32 as 3xTF32), K3's MQA head
# sum over a thread-block cluster of min(group, 8) blocks: (h, hk) covers
# group 8, 4 and 1, and 16 and 12 (clusters of 8 and 6 blocks, each looping
# over 2 heads); (n, m, causal, masked) the JAX tests' unaligned lengths,
# N != M without causality, a key mask.
GROUPS = [(8, 1), (8, 2), (8, 8), (16, 1), (12, 1)]
LENGTHS = [(48, 48, True, True), (50, 50, True, False), (37, 70, False, True)]
FORMS = ["table", "bias", "none"]
K13_CASES = [(h, hk, n, m, causal, masked, form)
             for h, hk in GROUPS for n, m, causal, masked in LENGTHS for form in FORMS
             if form != "table" or n == m]


def _k13_inputs(h, hk, n, m, masked, form, *, b=2, seed=20):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in [(b, h, n, 64), (b, hk, m, 64), (b, hk, m, 64), (b, h, n, 64)])
    tab = bias = mask = None
    if form == "table":
        tab = torch.from_numpy((0.5 * rng.normal(size=(2 * n - 1, h))).astype(np.float32))
    if form == "bias":
        bias = torch.from_numpy((0.5 * rng.normal(size=(h, n, m))).astype(np.float32))
    if masked:
        mask = torch.ones(b, m, dtype=torch.bool)
        mask[1, (2 * m) // 3:] = False
        mask[0, 3:7] = False
    return q, k, v, g, tab, bias, mask


def _to(cuda, dtype, q, k, v, g, tab, bias, mask):
    return ([a.to(cuda, dtype) for a in (q, k, v, g)]
            + [None if a is None else a.to(cuda) for a in (tab, bias, mask)])


@pytest.mark.parametrize("dtype,tol,rtol,atol", [(torch.float32, 2e-3, 1e-2, 1e-3),
                                                 (torch.bfloat16, 3e-2, 3e-2, 3e-2)])
@pytest.mark.parametrize("h,hk,n,m,causal,masked,form", K13_CASES)
def test_k1_and_k3_match_plain_version(cuda, h, hk, n, m, causal, masked, form, dtype, tol,
                                       rtol, atol):
    q, k, v, g, tab, bias, mask = _to(cuda, dtype, *_k13_inputs(h, hk, n, m, masked, form))
    kw = dict(bias_tab=tab, bias=bias, key_mask=mask, causal=causal)
    before = fa.launches, fa.launches_dkv
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-3, atol=2e-3)
    grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                   scale=64 ** -0.5)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_dkv) == (before[0] + 1, before[1] + 1)
    ref = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                     scale=64 ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        torch.testing.assert_close(a.float(), r.float(), rtol=rtol, atol=atol, msg=name)


def _f64_errors(case, cuda):
    """max |kernel - float64| / max |float64| of K1's out and K3's dk and dv
    (fed the float64 lse and Delta), in float32; the float64 evaluation is
    the plain versions' on float64 inputs."""
    h, hk, n, m, causal, masked, form = case
    q, k, v, g, tab, bias, mask = _to(cuda, torch.float32,
                                      *_k13_inputs(h, hk, n, m, masked, form, seed=21))
    q64, k64, v64, g64 = (a.double() for a in (q, k, v, g))
    tab64, bias64 = (None if a is None else a.double() for a in (tab, bias))
    out64, lse64 = fa.flash_attention_ref(q64, k64, v64, bias_tab=tab64, bias=bias64,
                                          key_mask=mask, causal=causal, scale=0.125,
                                          return_lse=True)
    _, dk64, dv64, _ = fa.flash_attention_bwd_ref(q64, k64, v64, tab64, mask, out64, lse64, g64,
                                                  causal=causal, scale=0.125, bias=bias64)
    delta64 = (g64 * out64).sum(-1)
    out = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask, causal=causal)
    kmask = None if mask is None else mask.to(torch.int8)
    dk, dv = fa.bwd_dkv(q, k, v, g, lse64.float(), delta64.float(), tab, kmask, causal=causal,
                        scale=0.125, bias=bias)
    return {name: float((a.double() - r).abs().max() / r.abs().max())
            for name, a, r in (("out", out, out64), ("dk", dk, dk64), ("dv", dv, dv64))}


F64_CASES = [(8, 1, 48, 48, True, True, "table"), (8, 2, 50, 50, True, False, "bias"),
             (8, 8, 37, 70, False, True, "none"), (16, 1, 200, 200, True, True, "table")]


@pytest.mark.parametrize("case", F64_CASES)
def test_fp32_k1_and_k3_hold_float64_to_1e5(cuda, case):
    # 3xTF32 keeps the float32 products near float32 accuracy
    errs = _f64_errors(case, cuda)
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("case", F64_CASES[:2])
def test_plain_tf32_build_fails_the_float64_check(cuda, case):
    # the same kernels built with the small terms dropped (plain TF32, ~5e-4)
    with fa.built_with(("MMA_TF32_ONE_PASS",)):
        errs = _f64_errors(case, cuda)
    assert min(errs.values()) > 1e-5, errs


@pytest.mark.parametrize("dtype,tol,rtol,atol", [(torch.float32, 2e-3, 1e-2, 1e-3),
                                                 (torch.bfloat16, 3e-2, 3e-2, 3e-2)])
@pytest.mark.parametrize("h,hk,form", [(8, 1, "table"), (8, 8, "bias"), (8, 2, "none")])
@pytest.mark.parametrize("causal", [False, True])
def test_k1_and_k3_with_whole_key_tiles_masked(cuda, causal, h, hk, form, dtype, tol, rtol,
                                               atol):
    # keys 0-69 masked in batch row 0 (left padding over a whole 64-key tile),
    # every key in row 1: rows whose first tile, or every tile, has no key
    n = 160
    q, k, v, g, tab, bias, _ = _to(cuda, dtype, *_k13_inputs(h, hk, n, n, False, form))
    mask = torch.ones(2, n, dtype=torch.bool, device=cuda)
    mask[0, :70] = False
    mask[1] = False
    kw = dict(bias_tab=tab, bias=bias, key_mask=mask, causal=causal)
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(lse, ref_lse, rtol=2e-3, atol=2e-3)
    # a causal row with no key spreads its weight over the key tiles it
    # visits, the plain version over every key: only lse (-1e30) says it is
    # empty, and the backward gives it no gradient
    rows = torch.ones(2, n, dtype=torch.bool, device=cuda)
    if causal:
        rows[0, :70] = False
        rows[1] = False
    torch.testing.assert_close(out.float().transpose(1, 2)[rows], ref.float().transpose(1, 2)[rows],
                               rtol=tol, atol=tol)
    grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                   scale=64 ** -0.5)
    ref = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                     scale=64 ** -0.5)
    # and the bias's gradient from K2's launch (K4 or K5); a row with no key has dS = 0
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        if r is None:
            assert a is None
            continue
        torch.testing.assert_close(a.float(), r.float(), rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hk,form", [(8, 1, "table"), (8, 2, "bias"), (12, 1, "none")])
def test_k3_gives_the_same_bits_every_run(cuda, h, hk, form, dtype):
    # the cluster's head sum runs in a fixed rank order, with no atomics
    q, k, v, g, tab, bias, mask = _to(cuda, dtype, *_k13_inputs(h, hk, 300, 300, True, form))
    out, lse = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask, causal=True,
                                  return_lse=True)
    args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1), tab, mask.to(torch.int8))
    first = fa.bwd_dkv(*args, causal=True, scale=0.125, bias=bias)
    for _ in range(3):
        again = fa.bwd_dkv(*args, causal=True, scale=0.125, bias=bias)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_k1_and_k3_issue_tensor_core_instructions(cuda):
    # both dtypes: warpgroup products (HGMMA: S = Q K^T in K1, S^T and dP^T in
    # K3, and in bf16 the products with P as well) fed by TMA loads (UTMALDG)
    # every instantiation: one or two consumer warpgroups a block
    found = {}
    for src in (fa.SOURCE, fa.SOURCE_BWD):
        for mangled, ops in _build.sass_counts(src).items():
            for kernel in ("flash_fwd_kernel", "flash_bwd_dkv_kernel"):
                if kernel in mangled:
                    found.setdefault((kernel, "bf16" if "bfloat16" in mangled else "fp32"),
                                     []).append((ops["HGMMA"], ops["UTMALDG"]))
    assert len(found) == 4, found
    assert all(all(all(ops) for ops in each) for each in found.values()), found


def test_wrapper_raises_on_a_misaligned_cuda_tensor(cuda):
    buf = torch.zeros(1 * 2 * 16 * 64 + 1, device=cuda)
    q = buf[1:].view(1, 2, 16, 64)  # contiguous, 4 bytes past an alignment
    kv = torch.zeros(1, 1, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(q, kv, kv, causal=True)


# K2 on the tensor cores, with K4 (table) or K5 (bias) in its launch: MQA
# groups 1 to 16 (GROUPS); batch sizes 1, 3, 4 and 9, which make K5's
# cluster of batch rows 1, 3 and 4 blocks, and at 9 three clusters of 3 whose
# partial tiles meet by atomics; N != M without causality; a key mask.
K2_CASES = ([(h, hk, b, n, m, causal, True, "bias") for h, hk in GROUPS for b in (1, 3, 4, 9)
             for n, m, causal in ((130, 130, True), (37, 70, False))]
            + [(h, hk, b, 48, 48, True, True, "table") for h, hk in GROUPS for b in (1, 4)]
            + [(h, hk, 3, 37, 70, False, True, "none") for h, hk in GROUPS])


def _k2_inputs(h, hk, b, n, m, masked, form, *, seed=30):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in [(b, h, n, 64), (b, hk, m, 64), (b, hk, m, 64), (b, h, n, 64)])
    tab = bias = mask = None
    if form == "table":
        tab = torch.from_numpy((0.5 * rng.normal(size=(2 * n - 1, h))).astype(np.float32))
    if form == "bias":
        bias = torch.from_numpy((0.5 * rng.normal(size=(h, n, m))).astype(np.float32))
    if masked:
        mask = torch.ones(b, m, dtype=torch.bool)
        mask[-1, (2 * m) // 3:] = False
        mask[0, 3:7] = False
    return q, k, v, g, tab, bias, mask


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-2, 1e-3),
                                             (torch.bfloat16, 3e-2, 3e-2)])
@pytest.mark.parametrize("h,hk,b,n,m,causal,masked,form", K2_CASES)
def test_k2_matches_plain_version(cuda, h, hk, b, n, m, causal, masked, form, dtype, rtol, atol):
    q, k, v, g, tab, bias, mask = _to(cuda, dtype, *_k2_inputs(h, hk, b, n, m, masked, form))
    out, lse = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask, causal=causal,
                                  return_lse=True)
    before = _counts() + (fa.launches_dbias,)
    grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                   scale=64 ** -0.5)
    torch.cuda.synchronize()
    # two launches, K2 (carrying K4 or K5) and K3
    assert _counts() + (fa.launches_dbias,) == (before[0] + 1, before[1] + 1,
                                                before[2] + (form == "table"),
                                                before[3] + (form == "bias"))
    ref = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                     scale=64 ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        if r is None:
            assert a is None
            continue
        assert a.dtype == r.dtype and a.shape == r.shape, name
        torch.testing.assert_close(a.float(), r.float(), rtol=rtol, atol=atol, msg=name)


def _k2_f64_errors(case, cuda):
    """max |kernel - float64| / max |float64| of K2's dq and, with a bias,
    its dbias (fed the float64 lse and Delta), in float32."""
    h, hk, b, n, m, causal, masked, form = case
    q, k, v, g, tab, bias, mask = _to(cuda, torch.float32,
                                      *_k2_inputs(h, hk, b, n, m, masked, form, seed=31))
    q64, k64, v64, g64 = (a.double() for a in (q, k, v, g))
    tab64, bias64 = (None if a is None else a.double() for a in (tab, bias))
    out64, lse64 = fa.flash_attention_ref(q64, k64, v64, bias_tab=tab64, bias=bias64,
                                          key_mask=mask, causal=causal, scale=0.125,
                                          return_lse=True)
    dq64, _, _, dgrad64 = fa.flash_attention_bwd_ref(q64, k64, v64, tab64, mask, out64, lse64,
                                                     g64, causal=causal, scale=0.125,
                                                     bias=bias64)
    delta64 = (g64 * out64).sum(-1)
    kmask = None if mask is None else mask.to(torch.int8)
    dq, dgrad = fa.bwd_dq(q, k, v, g, lse64.float(), delta64.float(), tab, kmask, causal=causal,
                          scale=0.125, bias=bias)
    errs = {"dq": float((dq.double() - dq64).abs().max() / dq64.abs().max())}
    if bias is not None:
        errs["dbias"] = float((dgrad.double() - dgrad64).abs().max() / dgrad64.abs().max())
    return errs


K2_F64_CASES = [(8, 1, 4, 130, 130, True, True, "bias"), (8, 2, 2, 200, 200, True, True, "table"),
                (8, 8, 3, 37, 70, False, True, "bias"), (16, 1, 9, 100, 100, True, True, "bias")]


@pytest.mark.parametrize("case", K2_F64_CASES)
def test_fp32_k2_holds_float64_to_1e5(cuda, case):
    # 3xTF32 keeps dq and dbias near float32 accuracy
    errs = _k2_f64_errors(case, cuda)
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("case", K2_F64_CASES[:2])
def test_plain_tf32_build_fails_the_k2_float64_check(cuda, case):
    # the same kernel built with the small terms dropped (plain TF32)
    with fa.built_with(("MMA_TF32_ONE_PASS",)):
        errs = _k2_f64_errors(case, cuda)
    assert min(errs.values()) > 1e-5, errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["bias", "table", "none"])
def test_k2_gives_the_same_bits_every_run(cuda, form, dtype):
    # dq in a fixed order; with B = 4 K5's cluster holds the batch, so dbias
    # is summed in rank order with no atomics; K4's dtab is summed in a fixed
    # order by its second pass
    q, k, v, g, tab, bias, mask = _to(cuda, dtype, *_k2_inputs(8, 1, 4, 300, 300, True, form))
    out, lse = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask, causal=True,
                                  return_lse=True)
    args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1), tab, mask.to(torch.int8))
    dq, dgrad = fa.bwd_dq(*args, causal=True, scale=0.125, bias=bias)
    for _ in range(3):
        again, again_grad = fa.bwd_dq(*args, causal=True, scale=0.125, bias=bias)
        assert torch.equal(dq, again)
        if dgrad is not None:
            assert torch.equal(dgrad, again_grad)


def test_k2_issues_tensor_core_instructions(cuda):
    # warpgroup products (HGMMA: S = Q K^T and dP = dO V^T, and in bf16 dS K)
    # fed by TMA loads (UTMALDG)
    found = {}
    for mangled, ops in _build.sass_counts(fa.SOURCE_BWD).items():
        if "flash_bwd_dq_kernel" in mangled:
            # three instantiations a dtype (its second int argument): with K5's
            # cluster sum (1), with a per-batch bias's dS (2) and without (0)
            form = re.findall(r"Li(\d+)E", mangled)[1]
            key = ("bf16" if "bfloat16" in mangled else "fp32", form)
            found[key] = found.get(key, ()) + ((ops["HGMMA"], ops["UTMALDG"]),)
    assert len(found) == 6 and all(all(all(x) for x in ops) for ops in found.values()), found


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 1e-2, 1e-3),
                                             (torch.bfloat16, 3e-2, 3e-2)])
def test_k2_with_k5_across_clusters(cuda, dtype, rtol, atol):
    # B = 12: clusters of 6 batch rows (64 rows shared unevenly among the
    # ranks), two a tile, whose partial dbias tiles meet by atomics
    q, k, v, g, tab, bias, mask = _to(cuda, dtype, *_k2_inputs(8, 2, 12, 200, 200, True, "bias"))
    assert fa.dq_plan(12, 8, 2, 200, 200, True, dtype, dbias=True)["cluster"] == 6
    out, lse = fa.flash_attention(q, k, v, bias=bias, key_mask=mask, causal=True,
                                  return_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, None, mask, out, lse, g, bias=bias, causal=True,
                                   scale=64 ** -0.5)
    ref = fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g, bias=bias, causal=True,
                                     scale=64 ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        torch.testing.assert_close(a.float(), r.float(), rtol=rtol, atol=atol, msg=name)


def _all_outputs(q, k, v, g, tab, bias, mask):
    """K1's out and lse, K2's dq and bias gradient, K3's dk and dv."""
    out, lse = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask, causal=True,
                                  return_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, bias=bias, causal=True,
                                   scale=0.125)
    return (out, lse, *grads)


@pytest.mark.parametrize("form", ["bias", "table"])
def test_integer_tf32_rounding_gives_the_conversions_bits(cuda, form):
    # tc::to_tf32 rounds by integer ops; the build with the conversion
    # instruction (cvt.rna.tf32.f32) must give the same float32 bits
    inputs = _to(cuda, torch.float32, *_k2_inputs(8, 1, 4, 300, 300, True, form))
    ours = _all_outputs(*inputs)
    with fa.built_with(("MMA_TF32_CVT",)):
        theirs = _all_outputs(*inputs)
    for name, a, r in zip(("out", "lse", "dq", "dk", "dv", "dgrad"), ours, theirs):
        assert torch.equal(a, r), name


def _codec_g_and_d(model, wave, seed):
    """One training forward of the codec (the quantizers train, drawing
    from a CPU generator seeded with `seed`) with its gradients, then the
    discriminators' loss with the penalty and its gradients; the loss terms,
    the gradients by name, the quantizers' state after, and each
    quantizer's codes."""
    named = dict(model.named_parameters())
    gen = [n for n in named if not n.startswith(("discriminators", "stft_discriminator"))]
    dis = [n for n in named if n not in gen]
    codes = []
    hooks = [layer.register_forward_hook(lambda m, a, out: codes.append(out[1].cpu()))
             for layer in model.rq.rvqs[0].layers]
    total, terms = model(wave, train=True, generator=torch.Generator().manual_seed(seed),
                         return_loss_breakdown=True)
    for h in hooks:
        h.remove()
    g = torch.autograd.grad(total, [named[n] for n in gen], allow_unused=True)
    grads = {n: (torch.zeros_like(named[n]) if x is None else x).cpu() for n, x in zip(gen, g)}
    state = {k: v.cpu().clone() for k, v in model.rq.state_dict().items()}
    d_loss = model(wave, return_discr_loss=True, apply_grad_penalty=True)
    grads.update({n: x.cpu() for n, x in
                  zip(dis, torch.autograd.grad(d_loss, [named[n] for n in dis]))})
    return [v.detach().item() for v in terms] + [d_loss.item()], grads, state, codes


def test_codec_train_step_card_matches_cpu(cuda):
    # one G step and one D step with the penalty, from the same weights,
    # batch and draws: each loss term within 2e-3, the worst gradient leaf
    # by relative norm within 1e-3, the quantizers' state within 1e-4 of the
    # largest on the codes no differing frame touched, at most 1% of the
    # frames' codes different (near ties)
    kw = dict(channels=8, strides=(2, 4, 5), channel_mults=(2, 4, 8), codebook_dim=128,
              codebook_size=256, rq_num_quantizers=4, attn_window_size=64, attn_heads=2,
              attn_dim_head=64, si_snr_loss_weight=1.0, feature_loss_weight=10.0,
              rq_kwargs=dict(threshold_ema_dead_code=0.25),
              multi_scale_discr_kwargs=dict(channels=4, layers=2, groups=(1, 2), chan_max=16),
              complex_stft_discr_kwargs=dict(channels=4), seed=5)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = SoundStream(**kw, device="cpu")
        rng = np.random.default_rng(5)
        x, init = (torch.from_numpy(0.1 * rng.normal(size=(4, 8000)).astype(np.float32))
                   for _ in range(2))
        # kmeans init on another batch: its centers are rows of that batch's
        # residuals, and a frame that is one leaves the next quantizer a
        # residual of float32 noise, whose rotation-trick gradient is noise
        cpu(init, train=True, generator=torch.Generator().manual_seed(0))
        card = copy.deepcopy(cpu).to(cuda)
        state = copy.deepcopy(cpu.state_dict())
        launched = vq.launches, la.launches
        got = _codec_g_and_d(card, x.to(cuda), 1)
        assert vq.launches > launched[0] and la.launches == launched[1] + 4
        want = _codec_g_and_d(cpu, x, 1)
        # the CPU's own spread (one thread: another summation order); a leaf
        # whose gradient cancels to float32 noise (the decoder's last bias
        # under SI-SNR, which ignores an offset) is held to 4x it
        cpu.load_state_dict(state)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            again = _codec_g_and_d(cpu, x, 1)[1]
        finally:
            torch.set_num_threads(threads)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for a, b in zip(got[0], want[0]):
        assert abs(a - b) <= 2e-3 * max(abs(b), 1e-6), (got[0], want[0])
    largest = max(v.norm() for v in want[1].values())
    for name, ref in want[1].items():
        if ref.norm() > 1e-6 * largest:
            limit = max(1e-3, 4 * float((again[name] - ref).norm() / ref.norm()))
            assert (got[1][name] - ref).norm() / ref.norm() < limit, name
    touched, frames = {}, 0
    for q, (a, b) in enumerate(zip(got[3], want[3])):
        differ = a != b
        frames += int(differ.sum())
        touched[q] = set(a[differ].tolist()) | set(b[differ].tolist())
    assert frames <= 0.01 * x.shape[0] * x.shape[1] // 40
    for key, ref in want[2].items():
        if ref.is_floating_point():
            keep = torch.ones(ref.shape[0], dtype=torch.bool)
            keep[list(touched.get(int(key.split(".")[3]), ()))] = False
            assert (got[2][key][keep] - ref[keep]).abs().max() <= 1e-4 * ref.abs().max(), key
        else:
            assert torch.equal(got[2][key], ref), key


# the stage recipe's trainers in bf16 (batch 4, 4 heads of 64): the Semantic
# LM's table at N = 150, the Coarse and Fine LMs' (H, N, N) bias at N = 602
# and 1201, 15% of the keys forgotten
@pytest.mark.parametrize("n,form", [(150, "table"), (602, "bias"), (1201, "bias")])
def test_bf16_kernels_at_the_stage_trainers_shapes(cuda, n, form):
    rng = np.random.default_rng(n)
    b, h, d = 4, 4, 64
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda, torch.bfloat16)
               for s in [(b, h, n, d), (b, 1, n, d), (b, 1, n, d)])
    mask = torch.from_numpy(rng.random((b, n)) > 0.15).to(cuda)
    mask[:, 0] = True
    if form == "table":
        bias = dict(bias_tab=torch.from_numpy(0.5 * rng.normal(size=(2 * n - 1, h)).astype(
            np.float32)).to(cuda))
    else:
        bias = dict(bias=torch.from_numpy(0.5 * rng.normal(size=(h, n, n)).astype(
            np.float32)).to(cuda))
    kw = dict(bias, key_mask=mask, causal=True)
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-3, atol=2e-3)
    g = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    bkw = dict(causal=True, scale=d ** -0.5, bias=bias.get("bias"))
    tab = bias.get("bias_tab")
    grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, **bkw)
    ref = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, **bkw)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        torch.testing.assert_close(a.float(), r.float(), rtol=3e-2, atol=3e-2, msg=name)


def test_bf16_train_step_keeps_float32_masters(cuda):
    model, wrapper, batch = _acoustic("coarse")
    step = TransformerTrainStep(wrapper(transformer=model), bf16_compute=True, lr=1e-3,
                                device=cuda)
    before = _counts() + (fa.launches_dbias,)
    losses = [step.step(*batch) for _ in range(2)]
    torch.cuda.synchronize()
    # 2 layers x 2 steps of K2 (with K5) and K3; no K4
    assert _counts() + (fa.launches_dbias,) == (before[0] + 4, before[1] + 4, before[2],
                                                before[3] + 4)
    assert np.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for st in step.optimizer.state.values()
               for key, v in st.items() if key != "step")


# Text conditioning's forms of K1-K3: causal attention over M = P + N keys
# (a prefix of P keys every query sees), aligned to the bottom right (key k
# seen by query q iff k <= q + M - N) with an (H, N, M) bias or none, over
# MQA groups, offsets that are and are not a multiple of the 64-key tile,
# and the first key tile of a row wholly masked; and cross attention over a
# null key and a text (N queries over 17 keys, not causal), at training's
# N and at the decode step's N = 1.
OFFSET_CASES = [(8, 1, 37, 70, True, "bias"), (8, 8, 37, 70, True, "none"),
                (8, 2, 130, 146, True, "bias"), (8, 1, 130, 194, True, "bias"),
                (8, 1, 200, 280, True, "first_tile"), (16, 1, 603, 643, True, "bias"),
                (8, 1, 300, 17, False, "none"), (8, 8, 1, 17, False, "none")]


def _offset_inputs(h, hk, n, m, form, *, b=2, seed=40):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in [(b, h, n, 64), (b, hk, m, 64), (b, hk, m, 64), (b, h, n, 64)])
    bias = None
    if form in ("bias", "first_tile"):
        bias = torch.from_numpy((0.5 * rng.normal(size=(h, n, m))).astype(np.float32))
    mask = torch.ones(b, m, dtype=torch.bool)
    mask[1, 3:(m - n) // 2 + 3] = False  # a shorter text in the prefix
    mask[0, m - 5:] = False
    if form == "first_tile":
        mask[0, :70] = False  # query 0 still sees key m - n > 70
    return q, k, v, g, bias, mask


@pytest.mark.parametrize("dtype,tol,rtol,atol", [(torch.float32, 2e-3, 1e-2, 1e-3),
                                                 (torch.bfloat16, 3e-2, 3e-2, 3e-2)])
@pytest.mark.parametrize("h,hk,n,m,causal,form", OFFSET_CASES)
def test_causal_offset_and_cross_kernels_match_plain_version(cuda, h, hk, n, m, causal, form,
                                                             dtype, tol, rtol, atol):
    q, k, v, g, bias, mask = _offset_inputs(h, hk, n, m, form)
    q, k, v, g = (a.to(cuda, dtype) for a in (q, k, v, g))
    bias, mask = (None if a is None else a.to(cuda) for a in (bias, mask))
    kw = dict(bias=bias, key_mask=mask, causal=causal)
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-3, atol=2e-3)
    before = _counts() + (fa.launches_dbias,)
    grads = fa.flash_attention_bwd(q, k, v, None, mask, out, lse, g, bias=bias, causal=causal,
                                   scale=0.125)
    torch.cuda.synchronize()
    assert _counts() + (fa.launches_dbias,) == (before[0] + 1, before[1] + 1, before[2],
                                                before[3] + (bias is not None))
    ref = fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g, bias=bias, causal=causal,
                                     scale=0.125)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        if r is None:
            assert a is None
            continue
        if dtype == torch.float32:
            torch.testing.assert_close(a.float(), r.float(), rtol=rtol, atol=atol, msg=name)
        else:
            # over 17 keys every p is large and dk, dv sum many queries' bf16
            # terms: held by the largest error over the largest value
            err = float((a.float() - r.float()).abs().max() / r.float().abs().max())
            assert err <= tol, (name, err)


def test_causal_offset_needs_m_at_least_n(cuda):
    q = torch.zeros(1, 2, 70, 64, device=cuda)
    kv = torch.zeros(1, 1, 37, 64, device=cuda)
    with pytest.raises(ValueError, match="M >= N"):
        fa.flash_attention(q, kv, kv, causal=True)


OFFSET_F64_CASES = [(8, 1, 130, 194, True, "bias"), (8, 2, 300, 17, False, "none")]


def _offset_f64_errors(case, cuda):
    """max |kernel - float64| / max |float64| of K1's out, K2's dq (and
    dbias) and K3's dk, dv (fed the float64 lse and Delta), in float32."""
    h, hk, n, m, causal, form = case
    q, k, v, g, bias, mask = _offset_inputs(h, hk, n, m, form, b=4, seed=41)
    q, k, v, g = (a.to(cuda) for a in (q, k, v, g))
    bias, mask = (None if a is None else a.to(cuda) for a in (bias, mask))
    q64, k64, v64, g64 = (a.double() for a in (q, k, v, g))
    bias64 = None if bias is None else bias.double()
    out64, lse64 = fa.flash_attention_ref(q64, k64, v64, bias=bias64, key_mask=mask,
                                          causal=causal, scale=0.125, return_lse=True)
    dq64, dk64, dv64, dgrad64 = fa.flash_attention_bwd_ref(
        q64, k64, v64, None, mask, out64, lse64, g64, causal=causal, scale=0.125, bias=bias64)
    delta64 = (g64 * out64).sum(-1)
    out = fa.flash_attention(q, k, v, bias=bias, key_mask=mask, causal=causal)
    args = (q, k, v, g, lse64.float(), delta64.float(), None, mask.to(torch.int8))
    dq, dgrad = fa.bwd_dq(*args, causal=causal, scale=0.125, bias=bias)
    dk, dv = fa.bwd_dkv(*args, causal=causal, scale=0.125, bias=bias)
    pairs = [("out", out, out64), ("dq", dq, dq64), ("dk", dk, dk64), ("dv", dv, dv64)]
    if bias is not None:
        pairs.append(("dbias", dgrad, dgrad64))
    return {name: float((a.double() - r).abs().max() / r.abs().max()) for name, a, r in pairs}


@pytest.mark.parametrize("case", OFFSET_F64_CASES)
def test_fp32_offset_and_cross_kernels_hold_float64_to_1e5(cuda, case):
    errs = _offset_f64_errors(case, cuda)
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("case", OFFSET_F64_CASES)
def test_plain_tf32_build_fails_the_offset_float64_check(cuda, case):
    with fa.built_with(("MMA_TF32_ONE_PASS",)):
        errs = _offset_f64_errors(case, cuda)
    assert min(errs.values()) > 1e-5, errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", OFFSET_F64_CASES)
def test_offset_and_cross_backward_gives_the_same_bits_every_run(cuda, case, dtype):
    h, hk, n, m, causal, form = case
    q, k, v, g, bias, mask = _offset_inputs(h, hk, n, m, form, b=4, seed=42)
    q, k, v, g = (a.to(cuda, dtype) for a in (q, k, v, g))
    bias, mask = (None if a is None else a.to(cuda) for a in (bias, mask))
    out, lse = fa.flash_attention(q, k, v, bias=bias, key_mask=mask, causal=causal,
                                  return_lse=True)
    args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1), None, mask.to(torch.int8))
    for fn in (fa.bwd_dq, fa.bwd_dkv):
        first = fn(*args, causal=causal, scale=0.125, bias=bias)
        for _ in range(2):
            again = fn(*args, causal=causal, scale=0.125, bias=bias)
            assert all(a is None or torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("form", ["cross", "prefix"])
def test_conditioned_semantic_lm_card_matches_cpu(cuda, form):
    """Logits and a train step's gradients of a conditioned LM, card vs CPU."""
    cfg = dict(dim=128, depth=2, heads=2, dim_head=64, num_semantic_tokens=40,
               num_residual_streams=4, cond_dim=96, has_condition=True,
               cond_as_self_attn_prefix=form == "prefix")
    cpu = SemanticTransformer(**cfg, seed=3, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(43)
    ids = torch.from_numpy(rng.integers(0, 40, (2, 150)))
    te = torch.from_numpy(rng.normal(size=(2, 9, 96)).astype(np.float32))
    te[1, 5:] = 0
    with torch.no_grad():
        got = card(ids.to(cuda), text_embeds=te.to(cuda), cond_drop_prob=0.0)
        want = cpu(ids, text_embeds=te, cond_drop_prob=0.0)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)
    grads = {}
    for model, dev in ((card, cuda), (cpu, "cpu")):
        loss = SemanticTransformerWrapper(transformer=model)(
            ids.to(dev), text_embeds=te.to(dev), return_loss=True, train=True,
            generator=torch.Generator().manual_seed(5))
        loss.backward()
        grads[dev == "cpu"] = {n: p.grad.cpu() for n, p in model.named_parameters()
                               if p.grad is not None}
    assert set(grads[True]) == set(grads[False])
    for name, g in grads[True].items():
        torch.testing.assert_close(grads[False][name], g, rtol=1e-2, atol=1e-3, msg=name)


# streaming serving, the command line and the native loader on the card
STREAM_CODEC = dict(channels=8, strides=(2, 4, 5), channel_mults=(2, 4, 8), codebook_dim=128,
                    codebook_size=256, rq_num_quantizers=4, attn_window_size=64, attn_heads=2,
                    attn_dim_head=64, seed=6, discriminators=False)


def _stream_codec(device):
    """A small codec (window 64, 8 heads of 64: K7's shapes) with codebooks
    drawn from its encoder's frames."""
    codec = SoundStream(**STREAM_CODEC, device="cpu").eval()
    x = torch.from_numpy(0.1 * np.random.default_rng(6).normal(size=(2, 8000)).astype(np.float32))
    with torch.no_grad():
        h = codec.encode_frames(x).reshape(-1, 128)
        gen = torch.Generator().manual_seed(6)
        for i, layer in enumerate(codec.rq.rvqs[0].layers):
            layer.codebook.copy_(h[torch.randperm(h.shape[0], generator=gen)[:256]] * 0.5 ** i)
    return codec.to(device)


def test_streamed_codes_on_the_card_equal_its_tokenize(cuda):
    from audiolm_pytorch_tpu_torch import StreamingCodecEncoder
    codec = _stream_codec(cuda)
    x = (0.1 * np.random.default_rng(7).normal(size=(1, 40 * 300 + 17))).astype(np.float32)
    # the quantizers' input (the encoder's output) of each call
    hs = []
    hook = codec.rq.register_forward_pre_hook(lambda m, args: hs.append(args[0].detach()))
    with torch.no_grad():
        offline = codec.tokenize(torch.from_numpy(x).to(cuda)).cpu().numpy()
    enc = StreamingCodecEncoder(codec, chunk_frames=64)
    emit_one, emitted = enc._emit_one, []

    def noted(upto):
        emitted.append(upto - enc._emitted)  # the frames this window emits, its last
        return emit_one(upto)

    enc._emit_one = noted
    before = vq.launches, la.launches
    rng, outs, i = np.random.default_rng(8), [], 0
    while i < x.shape[1]:
        n = int(rng.integers(1000, 7001))
        outs.append(enc.push(x[:, i:i + n]))
        i += n
    outs.append(enc.flush())
    hook.remove()
    got = np.concatenate(outs, 2)
    chunks = -(-300 // 64)  # 4 whole chunks and the flush's
    assert (vq.launches - before[0], la.launches - before[1]) == (4 * chunks, chunks)
    assert got.dtype == np.int32 and got.shape == offline.shape == (1, 1, 300, 4)
    # the encoder's output of every emitted frame is the offline pass's but
    # for rounding, so a differing code can only be a near tie
    streamed = torch.cat([h[:, -n:] for h, n in zip(hs[1:], emitted)], 1)
    assert streamed.shape == hs[0].shape
    assert ((streamed - hs[0]).abs().max() / hs[0].abs().max()).item() <= 1e-5
    assert (got != offline).any(-1).mean() <= 0.01  # near ties only
    assert enc._wave.shape[1] // 40 <= enc.pad_frames + enc.context + enc.chunk + 7000 // 40 + 1


def test_streamed_decode_on_the_card_equals_its_decode(cuda):
    from audiolm_pytorch_tpu_torch import StreamingCodecDecoder
    codec = _stream_codec(cuda)
    codes = np.random.default_rng(9).integers(0, 256, size=(1, 1, 300, 4))
    with torch.no_grad():
        offline = codec.decode_from_codebook_indices(torch.from_numpy(codes).to(cuda))
    dec = StreamingCodecDecoder(codec, chunk_frames=16)
    before = la.launches
    outs = [dec.push(codes[:, :, i:i + 7]) for i in range(0, 300, 7)]
    outs.append(dec.flush())
    assert la.launches - before == -(-300 // 16)  # one K7 launch a chunk
    np.testing.assert_allclose(np.concatenate(outs, -1), offline.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    assert dec._codes.shape[2] <= dec.context + dec.chunk + 7 + dec.align


def test_cli_round_trip_on_the_card(cuda, tmp_path, capsys):
    import wave as wavfile

    from audiolm_pytorch_tpu_torch import cli
    from audiolm_pytorch_tpu_torch.training.checkpoint import save_pytree
    from audiolm_pytorch_tpu_torch.weights import codec_state_dict_to_jax
    from flac_writer import write_flac
    codec = _stream_codec("cpu")
    buffers = [n for n, _ in codec.named_buffers()]
    save_pytree(tmp_path / "codec.npz", codec_state_dict_to_jax(codec.state_dict(), buffers),
                extra_meta={"config": codec.config, "kind": "SoundStream"})
    pcm = np.round(8000 * np.random.default_rng(10).normal(size=4000)).astype(np.int16)
    with wavfile.open(str(tmp_path / "clip.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    write_flac(tmp_path / "clip.flac", pcm.astype(np.int64), 16000)
    codes = []
    for name in ("clip.wav", "clip.flac"):
        cli.main(["--device", "cuda", "tokenize", "--codec", str(tmp_path / "codec.npz"),
                  "--audio", str(tmp_path / name), "--output", str(tmp_path / f"{name}.npz")])
        codes.append(np.load(tmp_path / f"{name}.npz")["codes"])
    assert codes[0].dtype == np.int32 and codes[0].shape == (1, 1, 100, 4)
    np.testing.assert_array_equal(codes[0], codes[1])
    cli.main(["--device", "cuda", "decode", "--codec", str(tmp_path / "codec.npz"), "--codes",
              str(tmp_path / "clip.wav.npz"), "--output", str(tmp_path / "out.wav")])
    with wavfile.open(str(tmp_path / "out.wav"), "rb") as f:
        assert f.getframerate() == 16000 and f.getnframes() == 4000
        out = np.frombuffer(f.readframes(4000), "<i2").astype(np.int32)
    with torch.no_grad():
        ref = codec.decode_from_codebook_indices(torch.from_numpy(codes[0]).long())[0].numpy()
    want = np.clip(ref * 32767.0, -32768, 32767).astype(np.int32)
    assert np.abs(out - want).max() <= 1 and np.abs(out).max() > 0
    assert "wrote" in capsys.readouterr().out


def test_native_loader_builds_into_build(cuda, tmp_path):
    from audiolm_pytorch_tpu_torch.data import native_loader
    from audiolm_pytorch_tpu_torch.utils.audio_io import load_audio
    from flac_writer import write_flac
    assert native_loader.native_available(), native_loader.build_error("audioload")
    so = native_loader.library_path("audioload")
    assert so.exists() and so.parent.parts[-2:] == ("build", "native")
    x = np.round(3000 * np.sin(np.arange(3000) / 7.0)).astype(np.int64)
    write_flac(tmp_path / "x.flac", x, 16000)
    wav, sr = load_audio(tmp_path / "x.flac")
    assert sr == 16000 and wav.shape == (1, 3000)
    np.testing.assert_array_equal(wav[0], (x / 32768.0).astype(np.float32))


def test_gate_loop_and_squeeze_excite_card_match_cpu(cuda):
    """At the first encoder block's rate of 1 s at 16 kHz (16000 frames of
    64 channels): the scan's 14 passes and the causal mean on the card."""
    from audiolm_pytorch_tpu_torch.models.soundstream import GateLoop, SqueezeExcite
    x = torch.from_numpy(np.random.default_rng(21).normal(size=(2, 16000, 64)).astype(np.float32))
    for module in (GateLoop(64), SqueezeExcite(64)):
        with torch.no_grad():
            want = module(x)
            got = copy.deepcopy(module).to(cuda)(x.to(cuda)).cpu()
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5, type(module)


def test_encodec_and_lfq_codec_tokenize_on_the_card_as_on_the_cpu(cuda):
    """EnCodec at its default width (8 quantizers of 1024 x 128: K6 8 times a
    tokenize) and a small LFQ codec (K7 in its encoder): codes equal the
    CPU port's in at least 99% of the frames (the encoders' float32 sums
    differ in order, which moves a near tie either way); EnCodec's decode
    of the same codes within 1e-4 of the peak."""
    from audiolm_pytorch_tpu_torch import EncodecWrapper
    rng = np.random.default_rng(22)
    enc = EncodecWrapper(device="cpu").eval()
    x = torch.from_numpy((0.1 * rng.normal(size=(2, 24000))).astype(np.float32))
    card = copy.deepcopy(enc).to(cuda)
    before = vq.launches
    with torch.no_grad():
        got = card.tokenize(x.to(cuda)).cpu()
        assert vq.launches - before == 8
        want = enc.tokenize(x)
        assert (got != want).any(-1).float().mean().item() <= 0.01
        ref = enc.decode_from_codebook_indices(want)
        wave = card.decode_from_codebook_indices(want.to(cuda)).cpu()
    assert ((wave - ref).abs().max() / ref.abs().max()).item() <= 1e-4
    lfq = SoundStream(**dict(STREAM_CODEC, use_lookup_free_quantizer=True), device="cpu").eval()
    x = torch.from_numpy((0.1 * rng.normal(size=(2, 16000))).astype(np.float32))
    card = copy.deepcopy(lfq).to(cuda)
    before = la.launches
    with torch.no_grad():
        got = card.tokenize(x.to(cuda)).cpu()
        assert la.launches - before == 1
        assert (got != lfq.tokenize(x)).any(-1).float().mean().item() <= 0.01


def test_dropout_backward_reuses_the_forward_mask_on_the_card(cuda):
    """Attention dropout on the card: the backward of the plain path uses the
    mask of the forward (autograd saves it; nothing is drawn again): the
    gradients equal the CPU's given the same mask, and a second backward of
    the same graph gives the same bits."""
    from audiolm_pytorch_tpu_torch.ops import attention
    rng = np.random.default_rng(30)
    q = torch.from_numpy(rng.normal(size=(2, 4, 257, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 1, 257, 64)).astype(np.float32))
            for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(2, 4, 257, 64)).astype(np.float32))
    keep = torch.from_numpy(rng.random((2, 4, 257, 257)) < 0.9)
    draws = []

    def draw_keep(generator, shape, p, device):
        draws.append(tuple(shape))
        return keep.to(device)

    mp = pytest.MonkeyPatch()
    mp.setattr(attention, "draw_keep", draw_keep)
    try:
        outs = []
        for dev in ("cpu", cuda):
            xs = [x.to(dev).requires_grad_() for x in (q, k, v)]
            out = attention.attend(*xs, causal=True, dropout=0.1, generator=torch.Generator())
            first = torch.autograd.grad(out, xs, g.to(dev), retain_graph=True)
            second = torch.autograd.grad(out, xs, g.to(dev))
            assert all(torch.equal(a, b) for a, b in zip(first, second))
            outs.append([out.detach().cpu()] + [x.cpu() for x in first])
    finally:
        mp.undo()
    assert draws == [(2, 4, 257, 257)] * 2  # one draw a forward, none in a backward
    for got, want in zip(outs[1], outs[0]):
        assert ((got - want).norm() / want.norm()).item() <= 1e-5


def test_dropout_train_step_takes_the_plain_path_and_eval_takes_k1(cuda):
    lm = SemanticTransformer(dim=128, depth=2, heads=2, dim_head=64, num_semantic_tokens=32,
                             attn_dropout=0.1, ff_dropout=0.1, device=cuda)
    wrapper = SemanticTransformerWrapper(transformer=lm)
    ids = torch.randint(0, 32, (2, 100), device=cuda)
    before = fa.launches
    loss = TransformerTrainStep(wrapper, device=cuda).step(ids)
    assert np.isfinite(loss) and fa.launches == before
    with torch.no_grad():
        lm(ids)
    assert fa.launches - before == 2


@pytest.mark.parametrize("kind", ["coarse", "fine"])
def test_speculative_equals_sequential_on_the_card(cuda, kind):
    common = dict(dim=128, depth=2, heads=4, dim_head=64, num_residual_streams=4,
                  codebook_size=128, num_coarse_quantizers=3, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    if kind == "coarse":
        wrapper = CoarseTransformerWrapper(transformer=CoarseTransformer(
            **common, num_semantic_tokens=50))
        kw = dict(semantic_token_ids=torch.randint(0, 50, (2, 30), device=cuda),
                  max_time_steps=20)
    else:
        wrapper = FineTransformerWrapper(transformer=FineTransformer(
            **common, num_fine_quantizers=5))
        kw = dict(coarse_token_ids=torch.randint(0, 128, (2, 20, 3), device=cuda))
    seq = wrapper.generate(**kw, temperature=0.0, generator=gen)
    spec, stats = wrapper.generate(**kw, temperature=0.0, generator=gen, speculative=True,
                                   return_spec_stats=True)
    assert torch.equal(spec, seq) and stats["steps"] > 0


def test_ema_all_reduce_on_a_one_rank_nccl_group_is_the_identity(cuda):
    """VQ-EMA under a one-rank NCCL group: the counts and sums all-reduced
    over one rank leave the update as it is without a group."""
    import os
    import socket
    import torch.distributed as dist
    from audiolm_pytorch_tpu_torch.ops.quantize import VectorQuantizeEMA
    from audiolm_pytorch_tpu_torch.parallel import mesh as dp
    if dist.is_initialized():
        pytest.skip("a process group is already joined")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    dp.init_process_group(0, 1, init_method=f"tcp://localhost:{port}", device=cuda)
    try:
        mesh = dp.make_mesh()
        rng = np.random.default_rng(31)
        x = torch.from_numpy(rng.normal(size=(2, 300, 32)).astype(np.float32)).to(cuda)
        layers = [VectorQuantizeEMA(32, 64, kmeans_init=False,
                                    generator=torch.Generator().manual_seed(1)).to(cuda)
                  for _ in range(2)]
        for i, layer in enumerate(layers):
            with dp.data_parallel(mesh if i else None):
                layer(x, train=True, generator=torch.Generator().manual_seed(2))
        for name in ("codebook", "embed_avg", "cluster_size"):
            assert torch.equal(getattr(layers[0], name), getattr(layers[1], name))
    finally:
        dist.destroy_process_group()


# head dims the kernels are built for (32, 128) and ones they take zero-padded
# into the next of them (16 into 32, 96 into 128)
HEAD_DIM_CASES = [16, 32, 96, 128]


@pytest.mark.parametrize("dtype,tol,rtol,atol", [(torch.float32, 2e-3, 1e-2, 1e-3),
                                                 (torch.bfloat16, 3e-2, 3e-2, 3e-2)])
@pytest.mark.parametrize("form", ["table", "bias", "prefix", "cross"])
@pytest.mark.parametrize("d", HEAD_DIM_CASES)
def test_flash_kernels_at_head_dims(cuda, d, form, dtype, tol, rtol, atol):
    # K1, and K2 with K4 (table) or K5 (bias) in its launch, and K3 against
    # the plain versions, each launched once a call; MQA, a key mask
    b, h, n = 2, 4, 300
    m = {"prefix": n + 16, "cross": 17}.get(form, n)
    causal = form != "cross"
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)).to(cuda, dtype)
    k, v = (torch.from_numpy(rng.normal(size=(b, 1, m, d)).astype(np.float32)).to(cuda, dtype)
            for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)).to(cuda, dtype)
    tab = bias = None
    if form == "table":
        tab = torch.from_numpy((0.5 * rng.normal(size=(2 * n - 1, h))).astype(np.float32)).to(cuda)
    elif form in ("bias", "prefix"):
        bias = torch.from_numpy((0.5 * rng.normal(size=(h, n, m))).astype(np.float32)).to(cuda)
    mask = torch.ones(b, m, dtype=torch.bool, device=cuda)
    mask[1, (2 * m) // 3:] = False
    kw = dict(bias_tab=tab, bias=bias, key_mask=mask, causal=causal)
    names = ("launches", "launches_dq", "launches_dkv", "launches_dtab", "launches_dbias")
    before = [getattr(fa, x) for x in names]
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, causal=causal,
                                   scale=d ** -0.5, bias=bias)
    torch.cuda.synchronize()
    assert [getattr(fa, x) - c for x, c in zip(names, before)] == [
        1, 1, 1, int(tab is not None), int(bias is not None)]
    assert out.shape == q.shape and grads[0].shape == q.shape and grads[1].shape == k.shape
    ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-3, atol=2e-3)
    want = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, causal=causal,
                                      scale=d ** -0.5, bias=bias)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, want):
        if r is not None:
            torch.testing.assert_close(a.float(), r.float(), rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("d", HEAD_DIM_CASES)
def test_local_attention_kernel_at_head_dims(cuda, d, dtype, tol):
    # K7 on LocalMHA's strided views, masked and biased, launched once a call
    rng = np.random.default_rng(d)
    b, h, t, w = 2, 4, 300, 64
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * h * d)).astype(np.float32)).to(cuda, dtype)
    q, k, v = (a.reshape(b, t, h, d).transpose(1, 2) for a in qkv.chunk(3, dim=-1))
    mask = torch.ones(b, t, dtype=torch.bool, device=cuda)
    mask[1, 200:] = False
    bias = torch.from_numpy((0.3 * rng.normal(size=(h, w, 2 * w))).astype(np.float32)).to(cuda)
    before = la.launches
    out = la.local_attention(q, k, v, window_size=w, mask=mask, attn_bias=bias)
    torch.cuda.synchronize()
    assert la.launches == before + 1 and out.shape == q.shape
    ref = la.local_attention_ref(q, k, v, window_size=w, mask=mask, attn_bias=bias)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [32, 128])
def test_float32_kernels_at_head_dims_within_1e5_of_float64(cuda, d):
    # K1's out, K2's dq and K3's dk, dv (3xTF32) and K7's out within 1e-5 of
    # a float64 evaluation; the plain-TF32 build fails the same check
    rng = np.random.default_rng(d)
    b, h, n = 2, 4, 700
    q = torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.normal(size=(b, 1, n, d)).astype(np.float32)).to(cuda)
            for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)).to(cuda)
    tab = torch.from_numpy((0.5 * rng.normal(size=(2 * n - 1, h))).astype(np.float32)).to(cuda)
    qd, kd, vd, gd, td = (a.double() for a in (q, k, v, g, tab))
    ref, ref_lse = fa.flash_attention_ref(qd, kd, vd, bias_tab=td, causal=True, return_lse=True)
    want = fa.flash_attention_bwd_ref(qd, kd, vd, td, None, ref, ref_lse, gd, causal=True,
                                      scale=d ** -0.5)
    lq, lk, lv = (a.expand(b, h, n, d)[:, :, :300].contiguous() for a in (q, k, v))
    lref = la.local_attention_ref(*(a.double() for a in (lq, lk, lv)), window_size=64)
    errors = {}
    for name, defines in (("3xtf32", ()), ("tf32", ("MMA_TF32_ONE_PASS",))):
        with _build.built_with(defines):
            out, lse = fa.flash_attention(q, k, v, bias_tab=tab, causal=True, return_lse=True)
            grads = fa.flash_attention_bwd(q, k, v, tab, None, out, lse, g, causal=True,
                                           scale=d ** -0.5)
            local = la.local_attention(lq, lk, lv, window_size=64)
        errors[name] = [((a.double() - r).abs().max() / r.abs().max()).item()
                        for a, r in zip((out, *grads[:3], local), (ref, *want[:3], lref))]
    assert max(errors["3xtf32"]) < 1e-5, errors
    assert min(errors["tf32"]) > 1e-5, errors


# ---- the kernels' whole domain: K7 at every window, a per-batch (B, H, N, M)
# bias in K1-K3 with its gradient, grids past 65535 blocks in y or z

K7_WINDOWS = [8, 32, 48, 256]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("w", K7_WINDOWS)
def test_local_attention_kernel_at_any_window(cuda, w, dtype, tol):
    # LocalMHA's strided views, T not a multiple of w, with and without a key
    # mask and a bias; row 0's keys 0 .. w + 4 masked, so its queries 0 .. w + 4
    # have no key and take the mean of their own window's 2w value slots
    t = 3 * w + 37
    q, k, v = _strided_local(2, 4, t, dtype, cuda, seed=w)
    assert all(la._readable(a) is a for a in (q, k, v))
    mask = torch.ones(2, t, dtype=torch.bool, device=cuda)
    mask[0, :w + 5] = False
    mask[1, torch.from_numpy(np.random.default_rng(w).random(t) < 0.2).to(cuda)] = False
    mask[1, 0] = True
    bias = torch.from_numpy((0.3 * np.random.default_rng(w + 1).normal(size=(4, w, 2 * w)))
                            .astype(np.float32)).to(cuda)
    for kw in (dict(mask=mask, attn_bias=bias), dict(mask=mask), dict(attn_bias=bias), {}):
        before = la.launches
        out = la.local_attention(q, k, v, window_size=w, scale=8 / 64, **kw)
        torch.cuda.synchronize()
        assert la.launches == before + 1
        ref = la.local_attention_ref(q, k, v, window_size=w, scale=8 / 64, **kw)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    out = la.local_attention(q, k, v, window_size=w, mask=mask).float()
    vf = v[0].float()
    torch.testing.assert_close(out[0, :, :w], (vf[:, :w].sum(1, keepdim=True) / (2 * w))
                               .expand(-1, w, -1), rtol=tol, atol=tol)
    torch.testing.assert_close(out[0, :, w:w + 5], (vf[:, :2 * w].sum(1, keepdim=True)
                                                   / (2 * w)).expand(-1, 5, -1),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3), (torch.bfloat16, 3e-2)])
def test_local_attention_kernel_at_the_demo_codecs_shape(cuda, dtype, tol):
    # examples/train_audiolm_demo.py's codec: 4 heads of 16 (padded to 32),
    # window 32, 2 s at 200 frames a second, 8 clips; and its training batch
    for b, t in ((8, 400), (2, 128)):
        rng = np.random.default_rng(t)
        qkv = torch.from_numpy(rng.normal(size=(b, t, 3 * 4 * 16)).astype(np.float32))
        q, k, v = (a.reshape(b, t, 4, 16).transpose(1, 2) for a in qkv.to(cuda, dtype).chunk(3, -1))
        before = la.launches
        out = la.local_attention(q, k, v, window_size=32, scale=8 / 16)
        torch.cuda.synchronize()
        assert la.launches == before + 1 and out.shape == (b, 4, t, 16)
        ref = la.local_attention_ref(q, k, v, window_size=32, scale=8 / 16)
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


K7_ANY_F64_CASES = [(61, 8), (130, 32), (203, 48), (805, 256)]


@pytest.mark.parametrize("t,w", K7_ANY_F64_CASES)
def test_fp32_k7_holds_float64_to_1e5_at_any_window(cuda, t, w):
    assert _k7_f64_error(cuda, t, w, True) <= 1e-5


@pytest.mark.parametrize("t,w", K7_ANY_F64_CASES[1::2])
def test_plain_tf32_build_fails_the_k7_float64_check_at_any_window(cuda, t, w):
    with _build.built_with(("MMA_TF32_ONE_PASS",)):
        assert _k7_f64_error(cuda, t, w, True) > 1e-5


def _per_batch_inputs(cuda, dtype, b, h, hk, n, m, d=64, seed=50):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32)).to(cuda)

    q, g = arr(b, h, n, d).to(dtype), arr(b, h, n, d).to(dtype)
    k, v = arr(b, hk, m, d).to(dtype), arr(b, hk, m, d).to(dtype)
    bias = arr(b, h, n, m, scale=0.5)
    mask = torch.ones(b, m, dtype=torch.bool, device=cuda)
    mask[-1, (2 * m) // 3:] = False
    return q, k, v, g, bias, mask


PER_BATCH_CASES = [(2, 8, 1, 130, 130, True), (3, 4, 4, 37, 37, False), (2, 8, 2, 37, 70, True),
                   (9, 2, 1, 64, 64, True), (2, 4, 1, 50, 17, False)]


@pytest.mark.parametrize("dtype,tol,rtol,atol", [(torch.float32, 2e-3, 1e-2, 1e-3),
                                                 (torch.bfloat16, 3e-2, 3e-2, 3e-2)])
@pytest.mark.parametrize("b,h,hk,n,m,causal", PER_BATCH_CASES)
def test_per_batch_bias_kernels_match_plain_version(cuda, b, h, hk, n, m, causal, dtype, tol,
                                                    rtol, atol):
    # K1, K2 (writing dbias = dS per batch row in its launch) and K3 with a
    # (B, H, N, M) bias, MQA and not, N != M (causal at the bottom right),
    # beside the plain versions; each launched once a call, no K4 or K5
    q, k, v, g, bias, mask = _per_batch_inputs(cuda, dtype, b, h, hk, n, m)
    kw = dict(bias=bias, key_mask=mask, causal=causal)
    names = ("launches", "launches_dq", "launches_dkv", "launches_dtab", "launches_dbias",
             "launches_dbias_per_batch")
    before = [getattr(fa, x) for x in names]
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, None, mask, out, lse, g, bias=bias, causal=causal,
                                   scale=64 ** -0.5)
    torch.cuda.synchronize()
    assert [getattr(fa, x) - c for x, c in zip(names, before)] == [1, 1, 1, 0, 0, 1]
    ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-3, atol=2e-3)
    want = fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g, bias=bias,
                                      causal=causal, scale=64 ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, want):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        torch.testing.assert_close(a.float(), r.float(), rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_batch_dbias_gives_the_same_bits_every_run(cuda, dtype):
    q, k, v, g, bias, mask = _per_batch_inputs(cuda, dtype, 4, 8, 1, 300, 300)
    out, lse = fa.flash_attention(q, k, v, bias=bias, key_mask=mask, causal=True,
                                  return_lse=True)
    runs = [fa.flash_attention_bwd(q, k, v, None, mask, out, lse, g, bias=bias, causal=True,
                                   scale=64 ** -0.5) for _ in range(3)]
    for run in runs[1:]:
        for a, r in zip(run, runs[0]):
            assert torch.equal(a, r)
    assert runs[0][3].abs().max() > 0


def test_per_batch_bias_through_the_transformer_card_matches_cpu(cuda):
    # the port's Transformer with a (B, H, N, N) attn_bias: scoring and a
    # gradient on the card (K1-K3) against the CPU
    from audiolm_pytorch_tpu_torch.models.transformer import Transformer
    torch.manual_seed(0)
    cpu = Transformer(dim=64, depth=2, heads=4, dim_head=16, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.normal(size=(2, 90, 64)).astype(np.float32))
    bias = torch.from_numpy((0.5 * rng.normal(size=(2, 4, 90, 90))).astype(np.float32))
    # the loss <out, g>: the final LayerNorm makes |out|^2 all but constant
    g = torch.from_numpy(rng.normal(size=(2, 90, 64)).astype(np.float32))
    outs, grads = [], []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        xb = bias.to(dev).requires_grad_()
        out = model(x.to(dev), attn_bias=xb)
        grads.append(torch.autograd.grad((out * g.to(dev)).sum(), [xb, *model.parameters()],
                                         allow_unused=True))
        outs.append(out.detach().cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=2e-3, atol=2e-3)
    for a, r in zip(grads[1], grads[0]):
        if r is not None:
            torch.testing.assert_close(a.cpu(), r, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("b,h", [(1, 65600), (65600, 1)])
def test_flash_kernels_past_the_65535_grid_limit(cuda, b, h):
    # K2's heads (1 x 65600) and K3's b * hk (65600 x 1) past 65535, where
    # their grids' y extents once stopped; K1 with them
    rng = np.random.default_rng(b)
    q = torch.from_numpy(rng.normal(size=(b, h, 64, 32)).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.normal(size=(b, 1, 64, 32)).astype(np.float32)).to(cuda)
            for _ in range(2))
    g = torch.from_numpy(rng.normal(size=(b, h, 64, 32)).astype(np.float32)).to(cuda)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, None, None, out, lse, g, causal=True,
                                   scale=32 ** -0.5)
    ref = fa.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, ref, rtol=2e-3, atol=2e-3)
    want = fa.flash_attention_bwd_ref(q, k, v, None, None, out, lse, g, causal=True,
                                      scale=32 ** -0.5)
    for a, r in zip(grads[:3], want[:3]):
        torch.testing.assert_close(a, r, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("w", [32, 64])
def test_local_attention_past_the_65535_grid_limit(cuda, w):
    # T / 64 = 65537 query tiles, where the grid's y extent once stopped
    t = 64 * 65536 + 64
    rng = np.random.default_rng(w)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 1, t, 32)).astype(np.float32)).to(cuda)
               for _ in range(3))
    out = la.local_attention(q, k, v, window_size=w)
    ref = la.local_attention_ref(q, k, v, window_size=w)
    torch.testing.assert_close(out, ref, rtol=2e-3, atol=2e-3)


def test_vq_kernel_past_the_65535_grid_limit(cuda):
    # 65537 row tiles of a narrow codebook, where the grid's z extent once stopped
    n = 64 * 65536 + 1
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32)).to(cuda)
    cb = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)).to(cuda)
    got = vq.vq_nearest_code(x, cb)
    want = vq.vq_nearest_code_ref(x, cb)
    assert got.shape == want.shape == (n,)
    # identical, but where the float64 scores of the two picks differ by under
    # 1e-5 of the score's terms (the kernel sums in another order)
    bad = (got != want).nonzero()[:, 0]
    xd, ed = x[bad].double(), cb.double()

    def score(idx):
        e = ed[idx.long()]
        return -2 * (xd * e).sum(-1) + e.square().sum(-1)

    scale = xd.square().sum(-1) + ed.square().sum(-1).max()
    assert ((score(got[bad]) - score(want[bad])).abs() <= 1e-5 * scale).all()


# Head dims over 128: the kernels' column-sliced form (csrc/mma.cuh's
# tc::Wide), at 192, 256, 320 and 512 in both dtypes; every other head dim
# over 128 zero-padded to the next multiple of 64
WIDE_DIMS = (192, 256, 320, 512)
WIDE_FORMS = {"table": (2, 4, 1, 150, 150, True), "bias": (3, 2, 2, 130, 130, True),
              "batch": (2, 2, 1, 100, 100, True), "prefix": (2, 2, 1, 80, 97, True),
              "cross": (2, 4, 1, 90, 17, False)}


def _wide_inputs(cuda, form, d, dtype, seed=0):
    b, h, hk, n, m, causal = WIDE_FORMS[form]
    rng = np.random.default_rng(seed + d)

    def normal(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32)).to(cuda)

    q, g = normal(b, h, n, d).to(dtype), normal(b, h, n, d).to(dtype)
    k, v = normal(b, hk, m, d).to(dtype), normal(b, hk, m, d).to(dtype)
    mask = torch.from_numpy(rng.random((b, m)) > 0.2).to(cuda)
    mask[:, 0] = True
    tab = normal(2 * n - 1, h, s=0.5) if form == "table" else None
    bias = normal(h, n, m, s=0.5) if form in ("bias", "prefix") else \
        normal(b, h, n, m, s=0.5) if form == "batch" else None
    return q, k, v, g, tab, bias, mask, causal


@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, 2e-3, dict(rtol=1e-2, atol=1e-3)),
                                            (torch.bfloat16, 3e-2, dict(rtol=3e-2, atol=3e-2))])
@pytest.mark.parametrize("form", list(WIDE_FORMS))
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_column_sliced_kernels_match_plain_versions(cuda, d, form, dtype, tol, gtol):
    # K1, K2 (with K4, K5 or the per-batch bias's dS) and K3, each launched once
    q, k, v, g, tab, bias, mask, causal = _wide_inputs(cuda, form, d, dtype)
    names = ("launches", "launches_dq", "launches_dkv", "launches_dtab", "launches_dbias",
             "launches_dbias_per_batch")
    before = [getattr(fa, x) for x in names]
    out, lse = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                  causal=causal, return_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                   scale=d ** -0.5)
    torch.cuda.synchronize()
    want = [1, 1, 1, form == "table", form in ("bias", "prefix"), form == "batch"]
    assert [getattr(fa, x) - c for x, c in zip(names, before)] == want
    ref, ref_lse = fa.flash_attention_ref(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                          causal=causal, return_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-3, atol=2e-3)
    refs = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                      scale=d ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv", "dgrad"), grads, refs):
        if r is None:
            assert a is None
            continue
        assert a.shape == r.shape, name
        torch.testing.assert_close(a.float(), r.float(), **gtol, msg=name)


def _wide_f64_error(cuda, form, d):
    """max |kernel - float64| / max |float64| over K1's out, K2's dq (and
    its bias gradient) and K3's dk, dv, fed the float64 lse and Delta (K2's
    and K3's arguments padded to the backward's head dim as the wrapper
    pads them: float32's 129-255 to 256, their chunked form)."""
    q, k, v, g, tab, bias, mask, causal = _wide_inputs(cuda, form, d, torch.float32, seed=1)
    scale = d ** -0.5
    f64 = [None if a is None else a.double() for a in (q, k, v, g, tab, bias)]
    out64, lse64 = fa.flash_attention_ref(f64[0], f64[1], f64[2], bias_tab=f64[4], bias=f64[5],
                                          key_mask=mask, causal=causal, scale=scale,
                                          return_lse=True)
    refs = fa.flash_attention_bwd_ref(*f64[:3], f64[4], mask, out64, lse64, f64[3],
                                      causal=causal, scale=scale, bias=f64[5])
    out = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask, causal=causal)
    padded = fa._padded(q, k, v, g, d=fa.flash_head_dim(d, torch.float32, "K2"))
    args = (*padded, lse64.float(), (f64[3] * out64).sum(-1).float(), tab,
            mask.to(torch.int8).contiguous())
    dq, dgrad = fa.bwd_dq(*args, causal=causal, scale=scale, bias=bias)
    dk, dv = fa.bwd_dkv(*args, causal=causal, scale=scale, bias=bias)
    dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    pairs = [(out, out64), (dq, refs[0]), (dk, refs[1]), (dv, refs[2])]
    if refs[3] is not None:
        pairs.append((dgrad, refs[3]))
    return max(((a.double() - r).abs().max() / r.abs().max()).item() for a, r in pairs)


@pytest.mark.parametrize("form", ["table", "bias", "batch"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_column_sliced_float32_within_1e5_of_float64(cuda, d, form):
    assert _wide_f64_error(cuda, form, d) <= 1e-5
    with _build.built_with(("MMA_TF32_ONE_PASS",)):
        assert _wide_f64_error(cuda, form, d) > 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["table", "bias", "batch"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_column_sliced_backward_gives_the_same_bits_every_run(cuda, d, form, dtype):
    # K2 with K4's fixed-order sums, K5's rank-order batch sum or dS, and K3
    # (up to 256 their Hopper forms, bf16's and float32's chunked, on inputs
    # padded to 256 as the wrapper pads them)
    q, k, v, g, tab, bias, mask, causal = _wide_inputs(cuda, form, d, dtype, seed=2)
    out, lse = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                  causal=causal, return_lse=True)
    args = (*fa._padded(q, k, v, g, d=fa.flash_head_dim(d, dtype, "K2")), lse,
            (g.float() * out.float()).sum(-1), tab, mask.to(torch.int8).contiguous())
    for fn in (fa.bwd_dq, fa.bwd_dkv):
        first = fn(*args, causal=causal, scale=d ** -0.5, bias=bias)
        for _ in range(2):
            again = fn(*args, causal=causal, scale=d ** -0.5, bias=bias)
            assert all(torch.equal(a, b) for a, b in zip(first, again) if a is not None)


@pytest.mark.parametrize("d", [129, 160, 192, 256, 320, 512])
def test_every_head_dim_over_128_launches_the_kernels(cuda, d):
    # no ValueError: K1-K3 and K7 launch, counted by the wrappers
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.normal(size=(2, 2, 80, d)).astype(np.float32)).to(cuda)
    kv = q[:, :1].contiguous()
    before = fa.launches, fa.launches_dq, fa.launches_dkv, la.launches
    leaves = [a.clone().requires_grad_() for a in (q, kv, kv)]
    out = fa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out.square().sum(), leaves)
    local = la.local_attention(q, q, q, window_size=32)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_dq, fa.launches_dkv, la.launches) == tuple(
        c + 1 for c in before)
    assert out.shape == q.shape and local.shape == q.shape
    assert all(torch.isfinite(a).all() for a in (out, local, *grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,masked,biased", [(128, False, False), (32, True, True),
                                             (64, True, False)])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_column_sliced_k7_matches_plain_version(cuda, d, w, masked, biased, dtype):
    rng = np.random.default_rng(d + w)
    t = 3 * w + 37 if w < 128 else 100
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, t, d)).astype(np.float32)).to(cuda, dtype)
               for _ in range(3))
    mask = bias = None
    if masked:
        mask = torch.from_numpy(rng.random((2, t)) > 0.2).to(cuda)
        mask[0, :w + 5] = False  # rows without a key: their window's mean
    if biased:
        bias = torch.from_numpy(0.3 * rng.normal(size=(2, w, 2 * w)).astype(np.float32)).to(cuda)
    out = la.local_attention(q, k, v, window_size=w, mask=mask, attn_bias=bias)
    ref = la.local_attention_ref(q, k, v, window_size=w, mask=mask, attn_bias=bias)
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if dtype == torch.float32:
        kw = dict(window_size=w, mask=mask, attn_bias=None if bias is None else bias.double())
        ref64 = la.local_attention_ref(q.double(), k.double(), v.double(), **kw)
        err = ((out.double() - ref64).abs().max() / ref64.abs().max()).item()
        assert err <= 1e-5
        with _build.built_with(("MMA_TF32_ONE_PASS",)):
            one = la.local_attention(q, k, v, window_size=w, mask=mask, attn_bias=bias)
        assert ((one.double() - ref64).abs().max() / ref64.abs().max()).item() > 1e-5


def test_column_sliced_forms_issue_tensor_core_instructions(cuda):
    # mma.sync (HMMA) in every column-sliced instantiation: K1, K2 in its
    # three forms (none or K4, K5's sum, the per-batch dS), K3 and K7
    found = {}
    for src in (fa.SOURCE, fa.SOURCE_BWD, la.SOURCE):
        for mangled, ops in _build.sass_counts(src).items():
            hit = re.search(r"(flash_fwd|flash_bwd_dq|flash_bwd_dkv|local_attn)_wide_kernel",
                            mangled)
            if hit:
                ints = re.findall(r"Li(\d+)E", mangled)
                key = (hit.group(1), "bf16" if "bfloat16" in mangled else "fp32",
                       ints[0] if ints else "")
                found[key] = ops["HMMA"]
    assert len(found) == 2 * (1 + 3 + 1 + 1), found
    assert all(found.values()), found


# bf16's K2 (none or K4, K5's cluster sum, the per-batch dS) and K3 (the pair
# form: one consumer a gradient) at D = 256, their Hopper form over 128;
# 192 is padded to 256 by the wrappers. (b, h, hk, n, m, causal): K5 with a
# cluster of 3 batch rows, and at B = 12 two clusters of 6 a tile meeting by
# atomics; cross attention over 17 keys splits K3's query range (qsplit 4)
BF16_WIDE_FORMS = {"none": (2, 4, 1, 150, 150, True), "table": (2, 4, 1, 150, 150, True),
                   "bias": (3, 2, 2, 130, 130, True), "batch": (2, 2, 1, 100, 100, True),
                   "bias12": (12, 2, 1, 100, 100, True), "cross": (2, 8, 1, 1100, 17, False)}


def _bf16_wide_inputs(cuda, form, d, seed):
    b, h, hk, n, m, causal = BF16_WIDE_FORMS[form]
    rng = np.random.default_rng(seed + d)

    def normal(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32)).to(cuda)

    q, g = normal(b, h, n, d).to(torch.bfloat16), normal(b, h, n, d).to(torch.bfloat16)
    k, v = normal(b, hk, m, d).to(torch.bfloat16), normal(b, hk, m, d).to(torch.bfloat16)
    mask = torch.from_numpy(rng.random((b, m)) > 0.2).to(cuda)
    mask[:, 0] = True
    tab = normal(2 * n - 1, h, s=0.5) if form == "table" else None
    bias = normal(h, n, m, s=0.5) if form in ("bias", "bias12") else \
        normal(b, h, n, m, s=0.5) if form == "batch" else None
    out, lse = fa.flash_attention_ref(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                      causal=causal, return_lse=True)
    return q, k, v, g, tab, bias, mask, out, lse, causal


@pytest.mark.parametrize("form", list(BF16_WIDE_FORMS))
@pytest.mark.parametrize("d", [256, 192])
def test_bf16_d256_backward_matches_plain_version(cuda, d, form):
    # K2 in the form its bias asks for and K3, each launched once, against the
    # plain backward on the same out and lse (bf16's tolerance)
    q, k, v, g, tab, bias, mask, out, lse, causal = _bf16_wide_inputs(cuda, form, d, seed=60)
    names = ("launches_dq", "launches_dkv", "launches_dtab", "launches_dbias",
             "launches_dbias_per_batch")
    before = [getattr(fa, x) for x in names]
    grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                   scale=d ** -0.5)
    torch.cuda.synchronize()
    want = [1, 1, form == "table", form in ("bias", "bias12"), form == "batch"]
    assert [getattr(fa, x) - c for x, c in zip(names, before)] == want
    b, h, hk, n, m, _ = BF16_WIDE_FORMS[form]
    plan = fa.dq_plan(b, h, hk, n, m, causal, torch.bfloat16, dbias=True, d=d)
    assert (plan["cluster"], plan["atomic"]) == {"bias": (3, False), "bias12": (6, True)}.get(
        form, (plan["cluster"], plan["atomic"]))
    if form == "cross":
        assert fa.dkv_plan(b, h, hk, n, m, torch.bfloat16, d)["qsplit"] == 4
    refs = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                      scale=d ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv", "dgrad"), grads, refs):
        if r is None:
            assert a is None
            continue
        assert a.shape == r.shape, name
        if form == "cross" and name in ("dk", "dv"):
            # 8800 query rows sum into each of 17 keys: the bf16 rounding of dS^T
            # and P^T, the products' operands in every bf16 form (D = 64 and 128
            # as well), leaves noise over an absolute 3e-2 where a sum cancels,
            # so dk and dv are held to 1e-2 of their largest element
            assert (a.float() - r.float()).abs().max() <= 1e-2 * r.float().abs().max(), name
            continue
        torch.testing.assert_close(a.float(), r.float(), rtol=3e-2, atol=3e-2, msg=name)


@pytest.mark.parametrize("form", list(BF16_WIDE_FORMS))
@pytest.mark.parametrize("d", [256, 192])
def test_bf16_d256_backward_gives_the_same_bits_every_run(cuda, d, form):
    # K2 with K4's fixed-order sums, K5's rank-order batch sum or dS, and K3
    # summing dk and dv each in one consumer, then the cluster in rank order
    q, k, v, g, tab, bias, mask, out, lse, causal = _bf16_wide_inputs(cuda, form, d, seed=61)
    tabc, kmask, dense = fa._kernel_args(tab, mask, bias)
    args = (*fa._padded(q, k, v, g, d=256), lse, (g.float() * out.float()).sum(-1), tabc, kmask)
    for fn in (fa.bwd_dq, fa.bwd_dkv):
        if form == "bias12" and fn is fa.bwd_dq:
            continue  # K5's clusters meet by atomics at B = 12: the sum's order is not fixed
        first = fn(*args, causal=causal, scale=d ** -0.5, bias=dense)
        for _ in range(2):
            again = fn(*args, causal=causal, scale=d ** -0.5, bias=dense)
            assert all(torch.equal(a, b) for a, b in zip(first, again) if a is not None)


def test_bf16_d256_backward_refuses_an_unpadded_head_dim(cuda):
    # the library takes bf16's 129-255 only padded to 256 (flash_head_dim), so
    # no launch quietly takes the column-sliced form there
    q, k, v, g, tab, bias, mask, out, lse, _ = _bf16_wide_inputs(cuda, "none", 192, seed=62)
    args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1), None, None)
    for fn in (fa.bwd_dq, fa.bwd_dkv):
        with pytest.raises(RuntimeError, match="CUDA error"):
            fn(*args, causal=True, scale=192 ** -0.5)


def test_bf16_d256_plans_match_the_librarys(cuda):
    bf16 = torch.bfloat16
    for b, h, hk, n, m in ((4, 4, 1, 2049, 2049), (4, 2, 2, 603, 603), (4, 2, 1, 603, 603),
                           (4, 8, 1, 2049, 17), (9, 8, 8, 130, 130), (12, 8, 1, 100, 100),
                           (3, 2, 2, 130, 130), (2, 4, 1, 90, 17)):
        for dbias in (False, True):
            plan = fa.dq_plan(b, h, hk, n, m, True, bf16, dbias=dbias, d=256)
            assert fa.dq_plan_built(b, h, hk, n, m, bf16, dbias=dbias, d=256) == (
                plan["cluster"], plan["stages"], plan["smem"], plan["blocks"]), (b, h, n, m)
        plan = fa.dkv_plan(b, h, hk, n, m, bf16, 256)
        assert fa.dkv_plan_built(b, h, hk, n, m, bf16, 256) == tuple(
            plan[x] for x in ("cluster", "qsplit", "consumers", "stages", "smem", "blocks"))


def test_bf16_d256_backward_issues_tensor_core_instructions(cuda):
    # warpgroup products (HGMMA) fed by TMA loads (UTMALDG) in K2's three
    # forms at <bf16, 256> and in K3's pair form
    found = {}
    for mangled, ops in _build.sass_counts(fa.SOURCE_BWD).items():
        if "bfloat16" in mangled and "Li256E" in mangled and "flash_bwd_d" in mangled:
            ints = re.findall(r"Li(\d+)E", mangled)
            key = ("dkv_pair" if "dkv_pair" in mangled else f"dq {ints[1]}")
            found[key] = (ops["HGMMA"], ops["UTMALDG"])
    assert sorted(found) == ["dkv_pair", "dq 0", "dq 1", "dq 2"], found
    assert all(all(x) for x in found.values()), found


# bf16's K1 at D = 256, its rows form (two consumers on the halves of a
# 128-row block); 192 is padded to 256 by the wrapper. (b, h, hk, n, m,
# causal, bias form): a key mask in every form; N = 130 and 193 leave the
# last block's second half without rows or with one
BF16_FWD_FORMS = {"table": (2, 4, 1, 300, 300, True, "table"),
                  "bias": (3, 2, 2, 130, 130, True, "bias"),
                  "batch": (2, 2, 1, 100, 100, True, "batch"),
                  "prefix": (2, 2, 1, 80, 97, True, "bias"),
                  "cross": (2, 4, 1, 90, 17, False, None),
                  "decode": (2, 4, 1, 1, 17, False, None),
                  "ragged": (2, 2, 1, 193, 193, True, "table"),
                  "ragged_half": (2, 2, 1, 130, 130, False, "table")}


def _bf16_fwd_inputs(cuda, form, d, seed):
    b, h, hk, n, m, causal, kind = BF16_FWD_FORMS[form]
    rng = np.random.default_rng(seed + d)

    def normal(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32)).to(cuda)

    q = normal(b, h, n, d).to(torch.bfloat16)
    k, v = normal(b, hk, m, d).to(torch.bfloat16), normal(b, hk, m, d).to(torch.bfloat16)
    mask = torch.from_numpy(rng.random((b, m)) > 0.2).to(cuda)
    mask[:, 0] = True
    tab = normal(2 * n - 1, h, s=0.5) if kind == "table" else None
    bias = normal(h, n, m, s=0.5) if kind == "bias" else \
        normal(b, h, n, m, s=0.5) if kind == "batch" else None
    return q, k, v, tab, bias, mask, causal


@pytest.mark.parametrize("form", list(BF16_FWD_FORMS))
@pytest.mark.parametrize("d", [256, 192])
def test_bf16_d256_forward_matches_plain_version(cuda, d, form):
    # K1 launched once through the wrapper (192 padded to 256) against the
    # plain forward (bf16's tolerance; lse in float32)
    q, k, v, tab, bias, mask, causal = _bf16_fwd_inputs(cuda, form, d, seed=70)
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                  causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches - before == 1
    ref, ref_lse = fa.flash_attention_ref(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                          causal=causal, return_lse=True)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("form", list(BF16_FWD_FORMS))
@pytest.mark.parametrize("d", [256, 192])
def test_bf16_d256_forward_gives_the_same_bits_every_run(cuda, d, form):
    # each row's output from one consumer's walk over the key tiles in order
    q, k, v, tab, bias, mask, causal = _bf16_fwd_inputs(cuda, form, d, seed=71)
    tabc, kmask, dense = fa._kernel_args(tab, mask, bias)
    args = (*fa._padded(q, k, v, d=256), tabc, kmask)
    kw = dict(causal=causal, scale=d ** -0.5, bias=dense)
    first = fa.fwd(*args, **kw)
    for _ in range(2):
        again = fa.fwd(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_bf16_d256_forward_refuses_an_unpadded_head_dim(cuda):
    # the library takes bf16's 129-255 only padded to 256 (flash_head_dim), so
    # no launch quietly takes the column-sliced form there
    for d in (129, 192, 255):
        q, k, v, tab, bias, mask, causal = _bf16_fwd_inputs(cuda, "table", d, seed=72)
        tabc, kmask, _ = fa._kernel_args(tab, mask)
        with pytest.raises(RuntimeError, match="CUDA error"):
            fa.fwd(q, k, v, tabc, kmask, causal=causal, scale=d ** -0.5)
        with pytest.raises(ValueError, match="no K1 plan"):
            fa.fwd_plan_built(2, 4, 300, 300, torch.bfloat16, d)


def test_bf16_d256_forward_plans_match_the_librarys(cuda):
    for b, h, n, m in ((4, 4, 2049, 2049), (4, 2, 603, 603), (4, 8, 2049, 17), (4, 8, 1, 17),
                       (2, 2, 193, 193), (4, 8, 2049, 2065)):
        for d in (192, 256):
            plan = fa.fwd_plan(b, h, n, m, True, torch.bfloat16, d)
            assert fa.fwd_plan_built(b, h, n, m, torch.bfloat16, 256) == tuple(
                plan[x] for x in ("consumers", "stages", "smem", "blocks")), (b, h, n, m, d)


def test_bf16_d256_forward_issues_tensor_core_instructions(cuda):
    # warpgroup products (HGMMA) fed by TMA loads (UTMALDG) in K1's rows form
    found = {mangled: (ops["HGMMA"], ops["UTMALDG"])
             for mangled, ops in _build.sass_counts(fa.SOURCE).items()
             if "flash_fwd_kernel" in mangled and "bfloat16" in mangled and "Li256E" in mangled}
    assert len(found) == 1 and all(all(x) for x in found.values()), found


# float32's K2 (none or K4, K5's cluster sum, the per-batch dS) and K3 at D =
# 256, their chunked Hopper forms (Q and dO, or K and V, resident unsplit,
# the streamed operands 64 columns at a time); 192 is padded to 256 by the
# wrappers. (b, h, hk, n, m, causal, bias form): K5 with a cluster of 3
# batch rows, and at B = 12 two clusters of 6 a tile meeting by atomics; a
# causal prefix of 17 keys with an (H, N, M) bias; cross attention over 17
# keys splits K3's query range (qsplit 4); ragged N with the table, not
# causal
F32_WIDE_FORMS = {"none": (2, 4, 1, 150, 150, True, None),
                  "table": (2, 4, 1, 150, 150, True, "table"),
                  "bias": (3, 2, 2, 130, 130, True, "bias"),
                  "batch": (2, 2, 1, 100, 100, True, "batch"),
                  "bias12": (12, 2, 1, 100, 100, True, "bias"),
                  "prefix": (2, 2, 1, 80, 97, True, "bias"),
                  "cross": (2, 8, 1, 1100, 17, False, None),
                  "ragged": (2, 2, 1, 193, 193, False, "table")}


def _f32_wide_inputs(cuda, form, d, seed, dtype=torch.float32):
    b, h, hk, n, m, causal, kind = F32_WIDE_FORMS[form]
    rng = np.random.default_rng(seed + d)

    def normal(*shape, s=1.0):
        return torch.from_numpy((s * rng.normal(size=shape)).astype(np.float32)).to(cuda)

    q, g = normal(b, h, n, d).to(dtype), normal(b, h, n, d).to(dtype)
    k, v = normal(b, hk, m, d).to(dtype), normal(b, hk, m, d).to(dtype)
    mask = torch.from_numpy(rng.random((b, m)) > 0.2).to(cuda)
    mask[:, 0] = True
    tab = normal(2 * n - 1, h, s=0.5) if kind == "table" else None
    bias = normal(h, n, m, s=0.5) if kind == "bias" else \
        normal(b, h, n, m, s=0.5) if kind == "batch" else None
    out, lse = fa.flash_attention_ref(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                      causal=causal, return_lse=True)
    return q, k, v, g, tab, bias, mask, out, lse, causal


@pytest.mark.parametrize("form", list(F32_WIDE_FORMS))
@pytest.mark.parametrize("d", [256, 192])
def test_f32_d256_backward_matches_plain_version(cuda, d, form):
    # K2 in the form its bias asks for and K3, each launched once, against the
    # plain backward on the same out and lse (float32's gradient tolerance)
    q, k, v, g, tab, bias, mask, out, lse, causal = _f32_wide_inputs(cuda, form, d, seed=80)
    names = ("launches_dq", "launches_dkv", "launches_dtab", "launches_dbias",
             "launches_dbias_per_batch")
    before = [getattr(fa, x) for x in names]
    grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                   scale=d ** -0.5)
    torch.cuda.synchronize()
    per_batch = bias is not None and bias.ndim == 4
    want = [1, 1, tab is not None, bias is not None and not per_batch, per_batch]
    assert [getattr(fa, x) - c for x, c in zip(names, before)] == want
    b, h, hk, n, m, _, _ = F32_WIDE_FORMS[form]
    plan = fa.dq_plan(b, h, hk, n, m, causal, torch.float32, dbias=True, d=d)
    assert (plan["slices"], plan["items"]) == (1, 12)
    assert (plan["cluster"], plan["atomic"]) == {"bias": (3, False), "bias12": (6, True)}.get(
        form, (plan["cluster"], plan["atomic"]))
    dkv = fa.dkv_plan(b, h, hk, n, m, torch.float32, d)
    assert dkv["pair"] and dkv["items"] == 16 and (form != "cross" or dkv["qsplit"] > 1)
    refs = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, bias=bias, causal=causal,
                                      scale=d ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv", "dgrad"), grads, refs):
        if r is None:
            assert a is None
            continue
        assert a.shape == r.shape, name
        torch.testing.assert_close(a, r, rtol=1e-2, atol=1e-3, msg=name)


def _f32_d256_f64_error(cuda, form, d):
    """max |kernel - float64| / max |float64| over K2's dq (and its bias
    gradient) and K3's dk, dv at D = 256 (192 padded to it), fed the float64
    lse and Delta."""
    q, k, v, g, tab, bias, mask, _, _, causal = _f32_wide_inputs(cuda, form, d, seed=81)
    scale = d ** -0.5
    f64 = [None if a is None else a.double() for a in (q, k, v, g, tab, bias)]
    out64, lse64 = fa.flash_attention_ref(f64[0], f64[1], f64[2], bias_tab=f64[4], bias=f64[5],
                                          key_mask=mask, causal=causal, scale=scale,
                                          return_lse=True)
    refs = fa.flash_attention_bwd_ref(*f64[:3], f64[4], mask, out64, lse64, f64[3],
                                      causal=causal, scale=scale, bias=f64[5])
    tabc, kmask, dense = fa._kernel_args(tab, mask, bias)
    args = (*fa._padded(q, k, v, g, d=256), lse64.float(), (f64[3] * out64).sum(-1).float(),
            tabc, kmask)
    dq, dgrad = fa.bwd_dq(*args, causal=causal, scale=scale, bias=dense)
    dk, dv = fa.bwd_dkv(*args, causal=causal, scale=scale, bias=dense)
    pairs = [(dq[..., :d], refs[0]), (dk[..., :d], refs[1]), (dv[..., :d], refs[2])]
    if refs[3] is not None:
        pairs.append((dgrad, refs[3]))
    return max(((a.double() - r).abs().max() / r.abs().max()).item() for a, r in pairs)


@pytest.mark.parametrize("form", ["table", "bias", "batch", "prefix", "cross"])
@pytest.mark.parametrize("d", [256, 192])
def test_f32_d256_backward_within_1e5_of_float64(cuda, d, form):
    assert _f32_d256_f64_error(cuda, form, d) <= 1e-5
    with _build.built_with(("MMA_TF32_ONE_PASS",)):
        assert _f32_d256_f64_error(cuda, form, d) > 1e-5


@pytest.mark.parametrize("form", list(F32_WIDE_FORMS))
@pytest.mark.parametrize("d", [256, 192])
def test_f32_d256_backward_gives_the_same_bits_every_run(cuda, d, form):
    # K2 with K4's fixed-order sums, K5's rank-order batch sum or dS, and K3
    # summing dk and dv each in one consumer, then the cluster in rank order
    q, k, v, g, tab, bias, mask, out, lse, causal = _f32_wide_inputs(cuda, form, d, seed=82)
    tabc, kmask, dense = fa._kernel_args(tab, mask, bias)
    args = (*fa._padded(q, k, v, g, d=256), lse, (g.float() * out.float()).sum(-1), tabc, kmask)
    for fn in (fa.bwd_dq, fa.bwd_dkv):
        if form == "bias12" and fn is fa.bwd_dq:
            continue  # K5's clusters meet by atomics at B = 12: the sum's order is not fixed
        first = fn(*args, causal=causal, scale=d ** -0.5, bias=dense)
        for _ in range(2):
            again = fn(*args, causal=causal, scale=d ** -0.5, bias=dense)
            assert all(torch.equal(a, b) for a, b in zip(first, again) if a is not None)


def test_f32_d256_backward_refuses_an_unpadded_head_dim(cuda):
    # the library takes float32's 129-255 in the backward only padded to 256
    # (flash_head_dim(d, dtype, "K2")), so no launch quietly takes the
    # column-sliced form there; float32's K1 keeps it
    for d in (129, 192, 255):
        q, k, v, g, tab, bias, mask, out, lse, _ = _f32_wide_inputs(cuda, "none", d, seed=83)
        args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1), None, None)
        for fn in (fa.bwd_dq, fa.bwd_dkv):
            with pytest.raises(RuntimeError, match="CUDA error"):
                fn(*args, causal=True, scale=d ** -0.5)
        with pytest.raises(ValueError, match="no K2 plan"):
            fa.dq_plan_built(2, 4, 1, 150, 150, torch.float32, d=d)
        assert fa.fwd_plan_built(2, 4, 150, 150, torch.float32, fa.flash_head_dim(d, q.dtype)) \
            == tuple(fa.fwd_plan(2, 4, 150, 150, True, torch.float32, d)[x]
                     for x in ("consumers", "stages", "smem", "blocks"))


def test_f32_d256_plans_match_the_librarys(cuda):
    f32 = torch.float32
    for b, h, hk, n, m in ((4, 4, 1, 2049, 2049), (4, 2, 2, 603, 603), (4, 2, 1, 603, 603),
                           (4, 8, 1, 2049, 17), (9, 8, 8, 130, 130), (12, 8, 1, 100, 100),
                           (3, 2, 2, 130, 130), (2, 4, 1, 90, 17)):
        for d in (192, 256):
            for dbias in (False, True):
                plan = fa.dq_plan(b, h, hk, n, m, True, f32, dbias=dbias, d=d)
                assert fa.dq_plan_built(b, h, hk, n, m, f32, dbias=dbias, d=256) == (
                    plan["cluster"], plan["stages"], plan["smem"], plan["blocks"]), (b, h, n, m)
            plan = fa.dkv_plan(b, h, hk, n, m, f32, d)
            assert fa.dkv_plan_built(b, h, hk, n, m, f32, 256) == tuple(
                plan[x] for x in ("cluster", "qsplit", "consumers", "stages", "smem", "blocks"))


def test_f32_d256_backward_issues_tensor_core_instructions(cuda):
    # warpgroup products (HGMMA) fed by TMA loads (UTMALDG) in K2's three
    # chunked forms at D = 256 and in K3's chunked pair form: every product,
    # the ones whose N index is D too, on wgmma (no HMMA)
    found = {}
    for mangled, ops in _build.sass_counts(fa.SOURCE_BWD).items():
        if "_chunk_kernel" in mangled:
            ints = re.findall(r"Li(\d+)E", mangled)
            key = "dkv" if "dkv_chunk" in mangled else f"dq {ints[1]}"
            assert ints[0] == "256", mangled
            found[key] = (ops["HGMMA"], ops["UTMALDG"], ops["HMMA"])
    assert sorted(found) == ["dkv", "dq 0", "dq 1", "dq 2"], found
    assert all(x[0] and x[1] and not x[2] for x in found.values()), found
