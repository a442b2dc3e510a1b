"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--seed N]

Phases, each printing its name and seconds:
  1. device      - requires CUDA; prints the card and its power limit.
  2. build       - builds every kernel of the Semantic LM path with nvcc
                   (build/kernels/) and prints ptxas' register/spill lines.
  3. kernels     - each kernel against its plain PyTorch version at the shapes
                   of the main path (and a ragged, key-masked one), with its
                   time, the plain version's, one PyTorch library call's and
                   the least time the card could take (bound).
  4. scoring     - the flagship SemanticTransformer (dim 1024, depth 6, heads
                   8, vocab 500, 4 residual streams; random weights from
                   --seed) scores a 4 x 2048 batch: logits and loss; then the
                   card's logits are held against a CPU copy at 1 x 256.
  5. generation  - KV-cached greedy generation, batch 2, a 128-token prompt
                   and 64 new tokens; each step's logits are held against an
                   uncached scoring of the final sequence.
Each of the two paths, scoring and generation, sets the kernel launch count
to 0 just before its own calls and reads it just after them, before any check
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

import numpy as np
import torch

from audiolm_pytorch_tpu_torch import SemanticTransformer, SemanticTransformerWrapper
from audiolm_pytorch_tpu_torch.ops.kernels import _build
from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa
from audiolm_pytorch_tpu_torch.ops.relpos import toeplitz_expand

FLAGSHIP = dict(dim=1024, depth=6, heads=8, dim_head=64, num_semantic_tokens=500,
                num_residual_streams=4)
# H100 SXM published peaks (dense): HBM bytes/s; FLOP/s by input type
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
LOGITS_TOL = 2e-3  # float32 card vs CPU: summation order differs, nothing else
DEV = torch.device("cuda")


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
    t0 = time.perf_counter()
    _build.load(fa.SOURCE)
    print(f"build: {fa.SOURCE} in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.get(fa.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def flash_inputs(rng, b, h, n, d, dtype, key_mask_from=None):
    """q (b, h, n, d), MQA k/v (b, 1, n, d), the (2n-1, h) table, key mask."""
    dev = DEV
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev, dtype)
               for s in [(b, h, n, d), (b, 1, n, d), (b, 1, n, d)])
    tab = torch.from_numpy(0.5 * rng.standard_normal((2 * n - 1, h), dtype=np.float32)).to(dev)
    mask = None
    if key_mask_from is not None:
        mask = torch.ones(b, n, dtype=torch.bool, device=dev)
        mask[1:, key_mask_from:] = False
    return q, k, v, tab, mask


def flash_bound_ms(q, k, v, tab, mask):
    """Least time for the function on these inputs: each input read once,
    each output written once; the products of the attended (q, k) pairs."""
    b, h, n, d = q.shape
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * es + tab.numel() * 4 \
        + b * h * n * 4 + (mask.numel() if mask is not None else 0)
    keys = torch.ones(b, n, dtype=torch.bool, device=q.device) if mask is None else mask
    # causal: query i attends the valid keys j <= i
    pairs = int(keys.long().cumsum(1).sum()) * h
    flops = 4 * d * pairs
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
    h, n = q.shape[1], q.shape[2]
    fmask = toeplitz_expand(tab, n, n)[None].to(q.dtype)
    causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    keep = causal[None, None] if mask is None else causal[None, None] & mask[:, None, None, :]
    fmask = fmask.masked_fill(~keep, float("-inf"))
    ke, ve = k.expand(-1, h, -1, -1), v.expand(-1, h, -1, -1)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, ke, ve, attn_mask=fmask))
    bound_ms, bound_by = flash_bound_ms(q, k, v, tab, mask)
    print(f"flash [{label}]: max_abs_err {err:.3e} (tol {tol}) | kernel {ms:.4f} ms | "
          f"plain {plain_ms:.4f} ms | sdpa {library_ms:.4f} ms | bound {bound_ms:.4f} ms "
          f"({bound_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


@phase("kernels")
def kernel_phase(seed):
    rng = np.random.default_rng(seed)
    h, d = FLAGSHIP["heads"], FLAGSHIP["dim_head"]
    main = check_flash(*flash_inputs(rng, 4, h, 2048, d, torch.float32), "fp32 4x8x2048x64")
    check_flash(*flash_inputs(rng, 4, h, 2048, d, torch.bfloat16), "bf16 4x8x2048x64")
    check_flash(*flash_inputs(rng, 2, h, 1000, d, torch.float32, key_mask_from=700),
                "fp32 ragged 2x8x1000x64, keys >= 700 masked in row 1")
    check_flash(*flash_inputs(rng, 2, h, 1000, d, torch.bfloat16, key_mask_from=700),
                "bf16 ragged 2x8x1000x64, keys >= 700 masked in row 1")
    return main


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


def profile_scoring(fn, top=8):
    """Device time of one call by kernel, from torch.profiler, and the share
    of the call's wall time the device was busy."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    print(f"scoring profile (one 4x2048 call): device busy {busy:.2f} ms of {wall_ms:.2f} ms "
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
    fa.launches = 0
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
    launches = fa.launches
    if launches != depth * calls:
        raise AssertionError(f"flash launches {launches} != depth {depth} x calls {calls}")
    peak = torch.cuda.max_memory_allocated()
    tokens = ids[:, :-1].numel()
    print(f"scoring 4x2048: loss {loss.item():.4f} | {score_ms:.2f} ms per call "
          f"({tokens / score_ms * 1e3:.0f} tokens/s) | max_memory_allocated "
          f"{peak / 2**30:.3f} GiB | flash launches {launches} = {depth} x {calls}")
    profile_scoring(lambda: wrapper(ids, return_loss=True))

    small = ids[:1, :256]
    with torch.no_grad():
        card = model(small).cpu()
        cpu = cpu_model(small.cpu())
    err = (card - cpu).abs().max().item()
    if not torch.allclose(card, cpu, rtol=LOGITS_TOL, atol=LOGITS_TOL):
        raise AssertionError(f"card vs CPU logits at 1x256: max abs err {err}")
    print(f"scoring 1x256 card (flash kernel) vs CPU (plain): max abs err {err:.3e} "
          f"(tol {LOGITS_TOL})")
    return launches


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
    fa.launches = 0
    ids, logits = wrapper.generate(**gen, return_logits=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrapper.generate(**gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = fa.launches  # the cached prefill and decode steps take `attend`
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
          f"flash launches {launches}")
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    t0 = time.perf_counter()
    smi = device_phase()
    build_phase()
    flash = kernel_phase(args.seed)
    cpu_model = flagship(args.seed)
    model = copy.deepcopy(cpu_model).to(DEV)
    launches_scoring = scoring_phase(args.seed, model, cpu_model)
    launches_generation = generation_phase(args.seed, model)
    if launches_scoring == 0:
        raise AssertionError("the scoring path launched no flash-attention kernel")
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [dict(
        name="flash_fwd", route="cuda",
        source="audiolm_pytorch_tpu_torch/csrc/flash_fwd.cu",
        replaces="ops/pallas/flash_attention.py:34",  # in the JAX package
        launches=launches_scoring + launches_generation,
        launches_scoring=launches_scoring, launches_generation=launches_generation,
        **flash)]}))
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
