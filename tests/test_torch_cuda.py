"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (flash
forward K1, backward K2 (with the table's gradient K4, or an (H, N, M)
bias's K5, in its launch) and K3; the codec's nearest-code search K6 and
local attention K7) against their plain PyTorch versions; K1, K2 and K3 on
the tensor cores (over MQA groups of 1 to 16 and K2 over batch sizes 1 to
9, float32 within 1e-5 of float64 where a plain-TF32 build fails, rows
whose first key tile or every key is masked, K3's dk, dv and K2's dq and
dbias the same bits every run, HMMA in their SASS); K6 and K7 on the tensor
cores (K6 one launch a search, the same bits every run, its plain-TF32
build caught by the near-tie gate; K7 on strided views, with masked key
tiles and rows without a key, within 1e-5 of float64 where plain TF32
fails; HMMA in both); the
Semantic, Coarse and Fine LMs on the card against the same weights on the
CPU, in scoring and in train steps, and a small codec's round trip on the
card against the CPU. They skip where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import copy

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
    q = torch.zeros(2, 2, 16, 64, device=cuda)
    kv = q[:, :1].contiguous()
    with pytest.raises(ValueError, match="per-batch"):
        fa.flash_attention(q, kv, kv, bias=torch.zeros(2, 2, 16, 16, device=cuda), causal=True)


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
# cluster of 3), 9 tiles (rank 0 takes two); D not a multiple of 8 or 32
@pytest.mark.parametrize("n,c,d", [(1, 1024, 512), (7, 1024, 512), (800, 1024, 512),
                                   (1300, 1024, 512), (37, 100, 33), (130, 64, 16),
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
    found = {}
    for src, kernel in ((vq.SOURCE, "vq_nearest_kernel"), (la.SOURCE, "local_attn_kernel")):
        for mangled, ops in _build.sass_counts(src).items():
            if kernel in mangled:
                found[kernel, "bf16" if "bfloat16" in mangled else "fp32"] = ops["HMMA"]
    assert sorted(found) == [("local_attn_kernel", "bf16"), ("local_attn_kernel", "fp32"),
                             ("vq_nearest_kernel", "fp32")] and all(found.values()), found


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


@pytest.mark.parametrize("w,d", [(32, 64), (256, 64), (128, 32), (64, 128)])
def test_local_attention_raises_on_a_cuda_tensor_it_cannot_take(cuda, w, d):
    q = torch.zeros(1, 2, 100, d, device=cuda)
    with pytest.raises(ValueError):
        la.local_attention(q, q, q, window_size=w)


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
    found = {}
    for src in (fa.SOURCE, fa.SOURCE_BWD):
        for mangled, ops in _build.sass_counts(src).items():
            for kernel in ("flash_fwd_kernel", "flash_bwd_dkv_kernel"):
                if kernel in mangled:
                    found[kernel, "bf16" if "bfloat16" in mangled else "fp32"] = ops["HMMA"]
    assert len(found) == 4 and all(found.values()), found


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
    found = {}
    for mangled, ops in _build.sass_counts(fa.SOURCE_BWD).items():
        if "flash_bwd_dq_kernel" in mangled:
            # two instantiations a dtype: with K5's cluster sum and without
            key = ("bf16" if "bfloat16" in mangled else "fp32", "Lb1E" in mangled)
            found[key] = ops["HMMA"]
    assert len(found) == 4 and all(found.values()), found


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
