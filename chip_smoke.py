"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--seed N]

Phases, each printing its name and seconds:
  1. device      - requires CUDA; prints the card and its power limit.
  2. build       - builds every kernel source of the Semantic LM path with
                   nvcc (build/kernels/), one nvcc per source, all started
                   together, and prints ptxas' register/spill lines.
  3. kernels     - each kernel against its plain PyTorch version at the shapes
                   of the main path (and a ragged, key-masked one), with its
                   time, the plain version's, one PyTorch library call's and
                   the least time the card could take (bound): the forward K1,
                   and the backward K2 (dq) with K4 (the rel-pos table's
                   gradient) fused into its launch, and K3 (dk, dv), as a
                   whole backward through the autograd.Function against the
                   plain backward. The training shape (N = 2049: 2048 ids,
                   EOS appended, the last id dropped for the loss, the start
                   token prepended; a forgetful key mask padded True for the
                   start token) and the aligned N = 2048.
  4. scoring     - the flagship SemanticTransformer (dim 1024, depth 6, heads
                   8, vocab 500, 4 residual streams; random weights from
                   --seed) scores a 4 x 2048 batch: logits and loss; then the
                   card's logits are held against a CPU copy at 1 x 256.
  5. generation  - KV-cached greedy generation, batch 2, a 128-token prompt
                   and 64 new tokens; each step's logits are held against an
                   uncached scoring of the final sequence.
  6. training    - the flagship trains through TransformerTrainStep with the
                   JAX trainer's defaults on a fixed 4 x 2048 batch: one warm
                   step, five timed steps, a falling loss; the card's
                   gradients are held against the CPU port's at 1 x 256 on the
                   same weights and mask, leaf by leaf by relative norm, and
                   the same comparison is shown to reject the card's gradients
                   with dq zeroed in one layer; one step under torch.profiler.
Each path, scoring, generation and training, sets the kernel launch counts
to 0 just before its own calls and reads them just after, before any check
(CPU comparison, profile, uncached scoring of the generated ids) runs.

Ends with a JSON line of per-kernel numbers, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Any failed phase raises
and the script exits non-zero without that line. Imports torch, numpy, the
standard library and the port only; spawns only nvcc and nvidia-smi.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from audiolm_pytorch_tpu_torch import (SemanticTransformer, SemanticTransformerWrapper,
                                       TransformerTrainStep)
from audiolm_pytorch_tpu_torch.ops.kernels import _build
from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa
from audiolm_pytorch_tpu_torch.ops.relpos import toeplitz_expand
from audiolm_pytorch_tpu_torch.ops.sampling import generate_mask_with_prob

FLAGSHIP = dict(dim=1024, depth=6, heads=8, dim_head=64, num_semantic_tokens=500,
                num_residual_streams=4)
# H100 SXM published peaks (dense): HBM bytes/s; FLOP/s by input type
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
# gradients: the JAX package's tolerance in float32 (dtab also sums by atomics
# in an order that changes from run to run); bf16 rounding of dq, dk, dv
GRAD_TOL = {torch.float32: dict(rtol=1e-2, atol=1e-3),
            torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
# card vs CPU parameter gradients of the flagship, worst leaf by relative norm
# ||card - cpu|| / ||cpu||, over the leaves whose CPU gradient norm is over
# 1e-6 of the largest leaf's (below that it is rounding noise: the rel-pos
# MLP's output bias, whose true gradient is zero). Two float32 CPU runs that
# differ only in summation order (1 and 4 threads) read up to 6e-5; dq
# zeroed in one layer reads 1.0.
LEAF_TOL = 1e-3
TRAIN_IDS = (4, 2048)
# the sequence the attention of a train step sees: EOS appended, the last id
# dropped for the loss, the start token prepended
TRAIN_N = TRAIN_IDS[1] + 1
LOGITS_TOL = 2e-3  # float32 card vs CPU: summation order differs, nothing else
DEV = torch.device("cuda")
SOURCES = (fa.SOURCE, fa.SOURCE_BWD)
COUNTERS = ("launches", "launches_dq", "launches_dkv", "launches_dtab")


def phase(name):
    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"phase {name}: ok {time.perf_counter() - t0:.2f} s", flush=True)
            return out
        return run
    return wrap


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True).stdout.strip()


@phase("device")
def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    return smi


@phase("build")
def build_phase():
    def build(src):
        t0 = time.perf_counter()
        _build.load(src)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        secs = list(pool.map(build, SOURCES))
    print(f"build: {len(SOURCES)} sources in {time.perf_counter() - t0:.2f} s")
    for src, sec in zip(SOURCES, secs):
        print(f"  {src}: {sec:.2f} s")
        for line in _build.build_log.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())


def counts():
    return {name: getattr(fa, name) for name in COUNTERS}


def zero_counts():
    for name in COUNTERS:
        setattr(fa, name, 0)


def flash_inputs(rng, b, h, n, d, dtype, key_mask_from=None, forget_p=None):
    """q (b, h, n, d), MQA k/v (b, 1, n, d), the (2n-1, h) table, key mask:
    row 1 on masked from key_mask_from, or as in training a forgetful mask
    dropping forget_p of the keys of each row's n - 1 ids (the first kept),
    padded True for the start token."""
    dev = DEV
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
               for s in [(b, h, n, d), (b, 1, n, d), (b, 1, n, d)])
    tab = torch.from_numpy(0.5 * rng.standard_normal((2 * n - 1, h), dtype=np.float32)).to(dev)
    mask = None
    if key_mask_from is not None:
        mask = torch.ones(b, n, dtype=torch.bool, device=dev)
        mask[1:, key_mask_from:] = False
    if forget_p is not None:
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 31)))
        mask = generate_mask_with_prob((b, n - 1), forget_p, generator=gen, device=dev)
        mask = torch.nn.functional.pad(mask, (1, 0), value=True)
    return q, k, v, tab, mask


def flash_bound_ms(q, k, v, tab, mask, *, products=2, adds=0, extra_bytes=0):
    """Least time for the function on these inputs: q, k, v, the table and
    the mask read once, out and lse written once (plus `extra_bytes`), and
    `products` matrix products (plus `adds` additions) over the attended
    (q, k) pairs."""
    b, h, n, d = q.shape
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * es + tab.numel() * 4 \
        + b * h * n * 4 + (mask.numel() if mask is not None else 0) + extra_bytes
    keys = torch.ones(b, n, dtype=torch.bool, device=q.device) if mask is None else mask
    # causal: query i attends the valid keys j <= i
    pairs = int(keys.long().cumsum(1).sum()) * h
    flops = (2 * d * products + adds) * pairs
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_mask(q, tab, mask):
    """The float mask SDPA needs for the same function: the expanded bias,
    -inf above the diagonal and on masked keys. Its rows lie 16 elements
    apart (a view of a padded buffer), as SDPA's fused kernels need for an
    odd N. Yardstick only."""
    n = q.shape[2]
    fmask = toeplitz_expand(tab, n, n)[None].to(q.dtype)
    causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    keep = causal[None, None] if mask is None else causal[None, None] & mask[:, None, None, :]
    fmask = fmask.masked_fill(~keep, float("-inf"))
    padded = torch.empty(*fmask.shape[:-1], -(-n // 16) * 16, dtype=fmask.dtype,
                         device=fmask.device)
    padded[..., :n] = fmask
    return padded[..., :n]


def sdpa_kv(k, v, h):
    """k, v repeated over the h query heads, in memory: SDPA's memory-efficient
    kernel reads out of bounds on head-broadcast (stride 0) k, v at N = 2049
    (an illegal address on the H100 with torch 2.11)."""
    return (a.expand(-1, h, -1, -1).contiguous() for a in (k, v))


def check_flash(q, k, v, tab, mask, label):
    kw = dict(bias_tab=tab, key_mask=mask, causal=True)
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q, k, v, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[q.dtype]
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise AssertionError(f"flash kernel vs plain [{label}]: max abs err {err} over {tol}")
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), iters=3, warmup=1)
    # yardstick only, never called by the port: one SDPA call with the same float mask
    h = q.shape[1]
    fmask = sdpa_mask(q, tab, mask)
    ke, ve = sdpa_kv(k, v, h)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, ke, ve, attn_mask=fmask))
    bound_ms, bound_by = flash_bound_ms(q, k, v, tab, mask)
    print(f"flash [{label}]: max_abs_err {err:.3e} (tol {tol}) | kernel {ms:.4f} ms | "
          f"plain {plain_ms:.4f} ms | sdpa {library_ms:.4f} ms | bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, at=label)


def check_flash_bwd(q, k, v, tab, mask, label, seed):
    """The backward through the autograd.Function (K1, then K2 with K4 and
    K3) against the plain backward on the same out, lse and dO; then each
    launch alone on prepared arguments. The plain version and the library
    call compute the whole backward (dq, dk, dv and the table's gradient), so
    each kernel's row carries the same plain_ms and library_ms. K4 runs in
    K2's launch: its row carries that launch's time and bound, and the launch
    is timed once more without the table's gradient for K4's share."""
    b, h, n, d = q.shape
    scale = d ** -0.5
    kw = dict(causal=True, scale=scale)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    leaves = [a.detach().requires_grad_() for a in (q, k, v, tab)]
    out, lse = fa.flash_attention(*leaves[:3], bias_tab=leaves[3], key_mask=mask,
                                  causal=True, return_lse=True)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    out, lse = out.detach(), lse.detach()
    ref = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, **kw)
    tol = GRAD_TOL[q.dtype]
    errs = {}
    for name, a, r in zip(("dq", "dk", "dv", "dtab"), grads, ref):
        errs[name] = (a.float() - r.float()).abs().max().item()
        if not torch.allclose(a.float(), r.float(), **tol):
            raise AssertionError(f"flash backward vs plain [{label}] {name}: max abs err "
                                 f"{errs[name]} over {tol}")

    delta = (g.float() * out.float()).sum(-1)
    args = (q, k, v, g, lse, delta, tab.float().contiguous(),
            mask.to(torch.int8).contiguous() if mask is not None else None)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, **kw),
                       iters=3, warmup=1)
    # yardstick only, never called by the port: SDPA forward + backward with the
    # expanded float bias (its gradient included) minus SDPA forward
    # (dk, dv per query head: the MQA head sum is left out)
    fmask = sdpa_mask(q, tab, mask).requires_grad_()
    qs, ks, vs = (a.detach().requires_grad_() for a in (q, *sdpa_kv(k, v, h)))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=fmask)

    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs, fmask), g), iters=5)
    with torch.no_grad():
        fwd_ms = cuda_ms(sdpa, iters=5)
    library_ms = fwd_bwd_ms - fwd_ms
    es, rows = q.element_size(), b * h * n * 4
    # dq with dtab in one launch: 3 products, one add per pair for the
    # diagonal sums, dq and dtab written
    dq_ms = cuda_ms(lambda: fa.bwd_dq(*args, **kw))
    dq_bound = flash_bound_ms(q, k, v, tab, mask, products=3, adds=1,
                              extra_bytes=q.numel() * es + rows + tab.numel() * 4)
    dkv_ms = cuda_ms(lambda: fa.bwd_dkv(*args, **kw))
    dkv_bound = flash_bound_ms(q, k, v, tab, mask, products=4,
                               extra_bytes=2 * k.numel() * es + rows)
    # the same launch with the table read but no dtab output: K2 alone
    dq_out = torch.empty_like(q)
    dq_only_ms = cuda_ms(lambda: fa._bwd_launch("flash_bwd_dq", (dq_out, None), *args,
                                                 causal=True, scale=scale))
    result = {}
    for name, ms, (bound_ms, bound_by), err in (
            ("dq", dq_ms, dq_bound, errs["dq"]),
            ("dkv", dkv_ms, dkv_bound, max(errs["dk"], errs["dv"])),
            ("dtab", dq_ms, dq_bound, errs["dtab"])):
        result[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms, at=label)
        print(f"flash bwd {name} [{label}]: max_abs_err {err:.3e} | kernel {ms:.4f} ms | "
              f"bound {bound_ms:.4f} ms ({bound_by})")
    result["dtab"].update(fused_into="flash_bwd_dq", share_ms=dq_ms - dq_only_ms)
    print(f"flash bwd dtab [{label}]: in dq's launch, which takes {dq_only_ms:.4f} ms without "
          f"it: K4's share {dq_ms - dq_only_ms:.4f} ms")
    print(f"flash bwd [{label}]: plain backward {plain_ms:.4f} ms | sdpa fwd+bwd - fwd "
          f"{library_ms:.4f} ms ({fwd_bwd_ms:.4f} - {fwd_ms:.4f}) | tol {tol}")
    return result


@phase("kernels")
def kernel_phase(seed):
    rng = np.random.default_rng(seed)
    h, d = FLAGSHIP["heads"], FLAGSHIP["dim_head"]
    main = check_flash(*flash_inputs(rng, 4, h, 2048, d, torch.float32), "fp32 4x8x2048x64")
    check_flash(*flash_inputs(rng, 4, h, 2048, d, torch.bfloat16), "bf16 4x8x2048x64")
    train = f"{TRAIN_IDS[0]}x{h}x{TRAIN_N}x{d} (training), 15% of keys forgotten"
    check_flash(*flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, torch.float32, forget_p=0.15),
                f"fp32 {train}")
    check_flash(*flash_inputs(rng, 2, h, 1000, d, torch.float32, key_mask_from=700),
                "fp32 ragged 2x8x1000x64, keys >= 700 masked in row 1")
    check_flash(*flash_inputs(rng, 2, h, 1000, d, torch.bfloat16, key_mask_from=700),
                "bf16 ragged 2x8x1000x64, keys >= 700 masked in row 1")
    bwd = check_flash_bwd(*flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, torch.float32,
                                        forget_p=0.15), f"fp32 {train}", seed)
    check_flash_bwd(*flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, torch.bfloat16,
                                  forget_p=0.15), f"bf16 {train}", seed)
    check_flash_bwd(*flash_inputs(rng, 4, h, 2048, d, torch.float32, forget_p=0.15),
                    "fp32 4x8x2048x64, 15% of keys forgotten", seed)
    check_flash_bwd(*flash_inputs(rng, 4, h, 2048, d, torch.bfloat16, forget_p=0.15),
                    "bf16 4x8x2048x64, 15% of keys forgotten", seed)
    check_flash_bwd(*flash_inputs(rng, 2, h, 1000, d, torch.float32, key_mask_from=700),
                    "fp32 ragged 2x8x1000x64, keys >= 700 masked in row 1", seed)
    check_flash_bwd(*flash_inputs(rng, 2, h, 1000, d, torch.bfloat16, key_mask_from=700),
                    "bf16 ragged 2x8x1000x64, keys >= 700 masked in row 1", seed)
    return {"fwd": main, **bwd}


def flagship(seed):
    """The flagship model on the CPU, weights from `seed`."""
    model = SemanticTransformer(**FLAGSHIP, seed=seed, device="cpu").eval()
    # the dynamic hyper-connection weights are zero at init: make them count
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("dyn_alpha_w", "dyn_beta_w")):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape, dtype=np.float32)))
    return model


def profile(label, fn, top=8):
    """Device time of one call of fn by kernel, from torch.profiler, and the
    share of the call's wall time the device was busy."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a user annotation (such as the optimizer's step range) is
    # a span on the device's timeline, not work of its own
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(r[0] for r in rows)
    print(f"{label} profile: device busy {busy:.2f} ms of {wall_ms:.2f} ms "
          f"wall under the profiler ({100 * (1 - busy / wall_ms):.1f}% idle)")
    for ms, count, name in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:8.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {name[:90]}")


@phase("scoring")
def scoring_phase(seed, model, cpu_model):
    rng = np.random.default_rng(seed + 2)
    dev = DEV
    wrapper = SemanticTransformerWrapper(transformer=model)
    ids = torch.from_numpy(rng.integers(0, FLAGSHIP["num_semantic_tokens"], (4, 2048))).to(dev)
    depth = FLAGSHIP["depth"]
    torch.cuda.reset_peak_memory_stats()
    calls = 0
    zero_counts()
    with torch.no_grad():
        logits = model(ids, return_loss=True)
        loss = wrapper(ids, return_loss=True)
        calls += 2
        torch.cuda.synchronize()
        if logits.shape != (4, 2048, FLAGSHIP["num_semantic_tokens"] + 1):
            raise AssertionError(f"logits shape {tuple(logits.shape)}")
        if not (torch.isfinite(logits).all() and torch.isfinite(loss)):
            raise AssertionError(f"non-finite logits or loss {loss.item()}")
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            wrapper(ids, return_loss=True)
        torch.cuda.synchronize()
        score_ms = (time.perf_counter() - t0) / iters * 1e3
        calls += iters
    launched = counts()
    launches = launched["launches"]
    if launches != depth * calls:
        raise AssertionError(f"flash launches {launches} != depth {depth} x calls {calls}")
    peak = torch.cuda.max_memory_allocated()
    tokens = ids[:, :-1].numel()
    print(f"scoring 4x2048: loss {loss.item():.4f} | {score_ms:.2f} ms per call "
          f"({tokens / score_ms * 1e3:.0f} tokens/s) | max_memory_allocated "
          f"{peak / 2**30:.3f} GiB | flash launches {launches} = {depth} x {calls}")
    with torch.no_grad():
        profile("scoring (one 4x2048 call)", lambda: wrapper(ids, return_loss=True))

    small = ids[:1, :256]
    with torch.no_grad():
        card = model(small).cpu()
        cpu = cpu_model(small.cpu())
    err = (card - cpu).abs().max().item()
    if not torch.allclose(card, cpu, rtol=LOGITS_TOL, atol=LOGITS_TOL):
        raise AssertionError(f"card vs CPU logits at 1x256: max abs err {err}")
    print(f"scoring 1x256 card (flash kernel) vs CPU (plain): max abs err {err:.3e} "
          f"(tol {LOGITS_TOL})")
    return launched


@phase("generation")
def generation_phase(seed, model):
    dev = DEV
    rng = np.random.default_rng(seed + 3)
    vocab = FLAGSHIP["num_semantic_tokens"]
    # a prompt without consecutive repeats, so none is dropped
    steps = rng.integers(1, vocab, (2, 128))
    prompt = torch.from_numpy(np.cumsum(steps, axis=1) % vocab).to(dev)
    wrapper = SemanticTransformerWrapper(transformer=model)
    new = 64
    gen = dict(max_length=128 + new, prime_ids=prompt, temperature=1e-10,
               generator=torch.Generator(device=dev).manual_seed(seed))
    zero_counts()
    ids, logits = wrapper.generate(**gen, return_logits=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrapper.generate(**gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launched = counts()  # the cached prefill and decode steps take `attend`
    if not torch.equal(ids[:, :128], prompt):
        raise AssertionError("generated ids do not keep the prompt")
    with torch.no_grad():
        full = model(ids)
    worst = 0.0
    for row in range(ids.shape[0]):
        n = int((ids[row] >= 0).sum()) + 1  # up to and including the first EOS
        err = (logits[row, :n] - full[row, :n]).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(logits[row, :n], full[row, :n], rtol=LOGITS_TOL, atol=LOGITS_TOL):
            raise AssertionError(f"cached vs uncached logits, row {row}: max abs err {err}")
    rate = ids.shape[0] * new / gen_s
    print(f"generation b2 prompt 128 + {new}: {gen_s * 1e3:.1f} ms, {rate:.1f} tokens/s | "
          f"cached vs uncached logits max abs err {worst:.3e} (tol {LOGITS_TOL}) | "
          f"kernel launches {launched}")
    return launched


@phase("training")
def training_phase(seed, cpu_model):
    """The flagship's train step on the card: warm step, five timed steps,
    then the card's gradients against the CPU port's, then one profiled step."""
    rng = np.random.default_rng(seed + 4)
    vocab = FLAGSHIP["num_semantic_tokens"]
    model = copy.deepcopy(cpu_model).train()
    trainer = TransformerTrainStep(SemanticTransformerWrapper(transformer=model), device=DEV)
    ids = torch.from_numpy(rng.integers(0, vocab, TRAIN_IDS)).to(DEV)
    first = trainer.step(ids)  # warm step
    depth, steps = FLAGSHIP["depth"], 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [trainer.step(ids) for _ in range(steps)]  # .item() in each step syncs
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    launched = counts()
    peak = torch.cuda.max_memory_allocated()
    for name, n in launched.items():
        if n != depth * steps:
            raise AssertionError(f"training: {name} {n} != depth {depth} x steps {steps}")
    if not all(np.isfinite([first, *losses])):
        raise AssertionError(f"non-finite training loss: {[first, *losses]}")
    if not losses[-1] < first:
        raise AssertionError(f"training loss did not fall: {[first, *losses]}")
    print(f"training 4x2048, lr 3e-4, clip 0.5: losses {first:.4f} (warm) "
          + " ".join(f"{x:.4f}" for x in losses)
          + f" | {step_ms:.2f} ms per step ({ids.numel() / step_ms * 1e3:.0f} tokens/s) | "
          f"max_memory_allocated {peak / 2**30:.3f} GiB | launches {launched}")

    # card vs CPU gradients at 1 x 256, same weights, same forgetful mask
    small = ids[:1, :256]
    card = small_grads(model, small, seed)
    cpu = small_grads(copy.deepcopy(model).cpu(), small.cpu(), seed)
    errs = leaf_errors(card, cpu)
    worst = max(errs, key=errs.get)
    top = max(cpu, key=lambda n: cpu[n].abs().max())
    print(f"training 1x256 card (kernels) vs CPU (plain) gradients: worst of {len(errs)} of "
          f"{len(cpu)} leaves {errs[worst]:.3e} in {worst} (limit {LEAF_TOL}); largest "
          f"|g| {cpu[top].abs().max().item():.3e} in {top}")
    if errs[worst] > LEAF_TOL:
        raise AssertionError(f"card vs CPU gradient of {worst}: {errs[worst]:.3e} > {LEAF_TOL}")
    # the comparison must see a wrong layer: dq zeroed in one layer's backward
    layer = FLAGSHIP["depth"] // 2
    faulty = leaf_errors(small_grads(model, small, seed, zero_dq_call=layer), cpu)
    bad = max(faulty, key=faulty.get)
    print(f"training 1x256 with dq zeroed in backward call {layer} of {FLAGSHIP['depth']}: "
          f"worst leaf {faulty[bad]:.3e} in {bad}, {sum(e > LEAF_TOL for e in faulty.values())} "
          f"leaves over the limit: rejected")
    if faulty[bad] <= LEAF_TOL:
        raise AssertionError("the card vs CPU gradient check let a zeroed dq through")
    profile("training (one 4x2048 step)", lambda: trainer.step(ids), top=12)
    return launched


def small_grads(model, ids, seed, zero_dq_call=None):
    """{name: gradient on the CPU} of the train loss of `ids` under the
    forgetful mask drawn from `seed`; with zero_dq_call, K2's dq output of
    that backward call (1 = the last layer) is zeroed."""
    real, calls = fa.bwd_dq, [0]

    def faulty(*args, **kw):
        dq, dtab = real(*args, **kw)
        calls[0] += 1
        return (torch.zeros_like(dq) if calls[0] == zero_dq_call else dq), dtab

    fa.bwd_dq = faulty if zero_dq_call is not None else real
    try:
        model.zero_grad(set_to_none=True)
        SemanticTransformerWrapper(transformer=model)(
            ids, return_loss=True, train=True,
            generator=torch.Generator().manual_seed(seed)).backward()
    finally:
        fa.bwd_dq = real
    if zero_dq_call is not None and calls[0] < zero_dq_call:
        raise AssertionError(f"backward made {calls[0]} dq launches, not {zero_dq_call}")
    # every parameter, zero where the loss does not reach it
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
            for n, p in model.named_parameters()}


def leaf_errors(got, ref):
    """{name: ||got - ref|| / ||ref||} over the leaves whose `ref` norm is
    over 1e-6 of the largest leaf's."""
    top = max(g.norm().item() for g in ref.values())
    return {n: ((got[n] - r).norm() / r.norm()).item() for n, r in ref.items()
            if r.norm().item() > 1e-6 * top}


# the TPU kernel each port replaces, by line in the JAX package
KERNELS = [
    ("fwd", "flash_fwd", fa.SOURCE, "ops/pallas/flash_attention.py:34", "launches"),
    ("dq", "flash_bwd_dq", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:179", "launches_dq"),
    ("dkv", "flash_bwd_dkv", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:233",
     "launches_dkv"),
    # K4 is fused into K2's launch; its row carries that launch's numbers
    ("dtab", "flash_bwd_dq:dtab", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:344",
     "launches_dtab"),
]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    t0 = time.perf_counter()
    smi = device_phase()
    build_phase()
    timings = kernel_phase(args.seed)
    cpu_model = flagship(args.seed)
    model = copy.deepcopy(cpu_model).to(DEV)
    paths = {"scoring": scoring_phase(args.seed, model, cpu_model),
             "generation": generation_phase(args.seed, model)}
    paths["training"] = training_phase(args.seed, cpu_model)
    rows = []
    for key, name, source, replaces, counter in KERNELS:
        per_path = {f"launches_{p}": launched[counter] for p, launched in paths.items()}
        if sum(per_path.values()) == 0:
            raise AssertionError(f"the main path launched no {name} kernel")
        rows.append(dict(name=name, route="cuda", source=f"audiolm_pytorch_tpu_torch/csrc/{source}",
                         replaces=replaces,  # in the JAX package
                         launches=sum(per_path.values()), **per_path, **timings[key]))
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        sys.exit(1)
