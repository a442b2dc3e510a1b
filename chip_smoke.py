"""Drives the PyTorch/CUDA port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--seed N]

Phases, each printing its name and seconds:
  1. device      - requires CUDA; prints the card and its power limit.
  2. build       - builds every kernel source of the port with nvcc
                   (build/kernels/), and the test-only plain-TF32 variant of
                   each, one nvcc per library, all started together, and
                   prints ptxas' register/spill lines.
  3. kernels     - each kernel against its plain PyTorch version at the shapes
                   of the main path (and a ragged, key-masked one), with its
                   time, the plain version's, one PyTorch library call's and
                   the least time the card could take (bound; for the flash
                   kernels in float32 at the 3xTF32 tensor-core rate): the
                   forward K1, and the backward K2 (dq) with K4 (the rel-pos
                   table's gradient) fused into its launch, and K3 (dk, dv),
                   as a whole backward through the autograd.Function against
                   the plain backward, and K2 + K3 beside SDPA's backward.
                   The training shape (N = 2049: 2048 ids, EOS appended, the
                   last id dropped for the loss, the start token prepended; a
                   forgetful key mask padded True for the start token) and
                   the aligned N = 2048.
     sass        - HMMA (tensor-core) and FFMA instructions of each kernel in
                   the built SASS (cuobjdump); K1, K2, K3 and K7 must issue
                   HMMA in float32 and bf16, K6 in float32.
     tf32        - K1's output, K2's dq (and with the bias its dbias) and
                   K3's dk, dv in float32 (3xTF32) within 1e-5 of a float64
                   evaluation at the Semantic and Fine training shapes, the
                   plain-TF32 build shown to fail the same check; K2's dq and
                   dbias and K3's dk, dv the same bits over three runs; K7's
                   output the same at the codec's shapes; K6 on near ties at
                   the codec's shape within the near-tie gate, which rejects
                   its plain-TF32 build; K6's indices the same bits over
                   three runs.
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
  7-12. the Coarse and the Fine LM at the width bench.py gives them (dim 512,
                   depth 6, 8 heads of 64, 4 residual streams, codebook 1024,
                   3 coarse and 5 fine quantizers, 500 semantic tokens; random
                   weights from --seed), whose attention takes a materialised
                   (H, L, L) bias: K1-K3 read it tile by tile and K2's launch
                   gives its gradient (K5). For each: scoring of 4 x 3-s clips (50 Hz: 150
                   semantic ids and 450 coarse codes; 450 coarse and 750 fine
                   codes), with the card's logits held against the CPU port's
                   on a 1-s clip; KV-cached greedy generation of a 1-s clip
                   (150 coarse codes from 50 semantic ids, then the 250 fine
                   codes of those), each code's logits held against an
                   uncached scoring; training on the 4 x 3-s batch as in 6,
                   the card's gradients held against the CPU port's on a
                   short clip and the check shown to reject them with K2's
                   dbias zeroed in one layer; one step under torch.profiler.
  13. codec       - the SoundStream codec at bench.py's width
                   (AudioLMSoundStream(codebook_size=1024): channels 32,
                   codebook dim 512, 12 quantizers, local attention window
                   128, 8 heads of 64; random weights from --seed, float32,
                   cuDNN and matmul TF32 off), its codebooks filled from the
                   residuals of a calibration batch (random codebooks are
                   zeros, every search a tie): one tokenize ->
                   decode_from_codebook_indices round trip of 8 x 2-s clips
                   (K6 12 times, K7 twice), then timed, profiled, and held
                   against the CPU port on a 1-s clip (codes identical but
                   for near ties the encoders' deviation explains; the
                   waveform from the same codes).
  14. codec training - SoundStreamTrainer.train_step at the width of the
                   repository's trained codec (persist/soundstream_r5_73k.npz's
                   config: channels 48, codebook 1024 x 512, 8 quantizers,
                   window 64, 8 heads of 64, the small discriminators, its
                   loss weights; random weights from --seed) on 64 clips of 2 s
                   written as WAV from --seed, batch 8 x 1 s: the GAN (one warm
                   step with kmeans init, 8 timed: each G and D step by CUDA
                   events, the step by the host clock, the penalty at steps 0,
                   4 and 8; one step profiled) and the reconstruction phase (3
                   steps, the discriminators untouched). Gates: finite loss
                   terms; launch counts of one step (K6 once a kept quantizer in
                   the G forward, 8 in the D forward; K7 2 a forward); the
                   quantizers' buffers moved by the G step, not by the D step;
                   the EMA apart from the model after its warm copy; the card
                   against the CPU port on one G step and one D step with the
                   penalty from the same weights, batch and draws (loss terms,
                   the worst gradient leaf, the quantizers' state, the codes),
                   shown to reject the card with the encoder's K7 output
                   gradient zeroed; a saved and loaded trainer's next loss
                   bit-equal to the uninterrupted trainer's. K6 and K7 at the
                   training shapes against their plain versions.
  15. audiolm      - AudioLM at bench.py's _build_gen widths (the codec with 8
                   quantizers, the Semantic LM at the flagship width, the
                   Coarse and Fine LMs as in 7-12), greedy, batch 1: 50
                   semantic ids -> 150 coarse -> 250 fine codes -> 1 s of
                   audio; the card's decode of the grid against the CPU's.
The kernels phase also holds the (H, N, M)-bias form of K1-K3, with K5 in
K2's launch, to the plain versions at the Coarse and Fine training shapes (N = 1 + 151 + 1 + 450
= 603 and 1 + 450 + 1 + 749 = 1201: EOS appended, the last code dropped for
the loss) and at a ragged shape with a key mask; a second kernels phase
holds the codec's kernels to theirs: K6, the nearest-code search, at the
codec's shape (800 rows of 512 against 1024 codes) and at 1, 7 and 1300
rows, with tied codes, each search one device launch (torch.profiler); K7,
blocked local attention, at the codec's shape (8 x 8 x 100 x 64, window
128), at 10 s (8 x 8 x 500 x 64), a ragged, key-masked, biased 2 x 8 x 300 x
64 at window 64, on LocalMHA's strided views of one projection, and strided
with whole key tiles masked and rows without a key, fp32 and bf16, with its
backward. Each kernel row gives its time by CUDA events and on the device
(torch.profiler), and so does its library call.
Each path, scoring, generation and training of each LM, the codec's round
trip, a codec train step and AudioLM's generation, sets the kernel launch counts to 0 just
before its own calls and reads them just after, before any check (CPU
comparison, profile, uncached scoring of the generated ids) runs.

Ends with a JSON line of per-kernel numbers, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. Any failed phase raises
and the script exits non-zero without that line. Imports torch, numpy, the
standard library, the port and the timers of tools/cuda_timing.py only;
spawns only nvcc and nvidia-smi.
"""
from __future__ import annotations

import argparse
import copy
import json
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from audiolm_pytorch_tpu_torch import (AudioLM, AudioLMSoundStream, CoarseTransformer,
                                       CoarseTransformerWrapper, FineTransformer,
                                       FineTransformerWrapper, SemanticTransformer,
                                       SemanticTransformerWrapper, TransformerTrainStep,
                                       decode_acoustic_tokens)
from audiolm_pytorch_tpu_torch.ops.kernels import _build
from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa
from audiolm_pytorch_tpu_torch.ops.kernels import local_attention as la
from audiolm_pytorch_tpu_torch.ops.kernels import vq
from audiolm_pytorch_tpu_torch.ops.relpos import toeplitz_expand
from audiolm_pytorch_tpu_torch.ops.sampling import generate_mask_with_prob
from tools.cuda_timing import cuda_ms, device_per_call, kernel_events

FLAGSHIP = dict(dim=1024, depth=6, heads=8, dim_head=64, num_semantic_tokens=500,
                num_residual_streams=4)
# H100 SXM published peaks (dense): HBM bytes/s; FLOP/s by input type
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# every kernel's float32 products run as 3xTF32 on the tensor cores: three
# TF32 products (495 TFLOP/s) for each, so the float32 bound is taken at a
# third of that rate; K6's and K7's printed lines also give the bound at the
# FMA rate above (67 TFLOP/s), the rate of their earlier CUDA-core design
TF32X3_FLOPS = 495e12 / 3
# 3xTF32 (K1, K2, K3) against a float64 evaluation: max |kernel - ref| over
# max |ref|; plain TF32 (the small terms dropped) reads ~5e-4
F64_TOL = 1e-5
TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
# gradients: the JAX package's tolerance in float32; bf16 rounding of dq, dk, dv
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
SOURCES = (fa.SOURCE, fa.SOURCE_BWD, vq.SOURCE, la.SOURCE)
# a test-only build of every kernel with plain TF32 (the 3xTF32 small terms
# dropped), which the float64 checks (K1, K2, K3, K7) and the near-tie gate
# (K6) must reject
ONE_PASS = ("MMA_TF32_ONE_PASS",)
BUILDS = [(src, ()) for src in SOURCES] + [(src, ONE_PASS) for src in SOURCES]
# each kernel's launch counter: (its module, the counter's name there)
COUNTERS = {"launches": (fa, "launches"), "launches_dq": (fa, "launches_dq"),
            "launches_dkv": (fa, "launches_dkv"), "launches_dtab": (fa, "launches_dtab"),
            "launches_dbias": (fa, "launches_dbias"), "launches_vq": (vq, "launches"),
            "launches_local": (la, "launches")}
# the Coarse and Fine LMs at bench.py's width (bench.py:333-338)
ACOUSTIC = dict(dim=512, depth=6, heads=8, dim_head=64, num_residual_streams=4,
                codebook_size=1024, num_coarse_quantizers=3)
COARSE = dict(ACOUSTIC, num_semantic_tokens=500)
FINE = dict(ACOUSTIC, num_fine_quantizers=5)
HZ = 50  # frames per second of audio, semantic and acoustic alike
CLIP_S, CLIP_B = 3, 4  # the scoring and training batch: 4 clips of 3 s
# the attention length of a train step: start, ids + EOS, start, codes + EOS - 1
COARSE_N = 1 + (CLIP_S * HZ + 1) + 1 + CLIP_S * HZ * 3
FINE_N = 1 + CLIP_S * HZ * 3 + 1 + CLIP_S * HZ * 5 - 1


def phase(name):
    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"phase {name}: ok {time.perf_counter() - t0:.2f} s", flush=True)
            return out
        return run
    return wrap


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
    def build(job):
        t0 = time.perf_counter()
        _build.load(*job)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        secs = list(pool.map(build, BUILDS))
    print(f"build: {len(SOURCES)} sources and their 1xTF32 variants, {len(BUILDS)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for (src, defines), sec in zip(BUILDS, secs):
        print(f"  {src}{''.join(' -D' + x for x in defines)}: {sec:.2f} s")
        if defines:
            continue
        for line in _build.build_log.get(src, "").splitlines():
            if "Compiling entry" in line:
                print(f"    {kernel_label(line)}:")
            elif "registers" in line or "spill" in line:
                print("      ptxas:", line.strip())


def kernel_label(mangled):
    """flash_fwd_kernel<bf16> (or vq_nearest_kernel, not a template) from a
    kernel's mangled name: its length, the name, I and its template args;
    K2's instantiation with K5's cluster sum (a bool argument, true) is
    flash_bwd_dq_kernel<bf16, sum>."""
    entry = re.search(r"\d([a-z][a-z_]*_kernel)(I?)", mangled)
    if not entry.group(2):
        return entry.group(1)
    dtype = "bf16" if "bfloat16" in mangled else "fp32"
    return f"{entry.group(1)}<{dtype}{', sum' if 'Lb1E' in mangled else ''}>"


def counts():
    return {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}


def zero_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


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


def dense_bias(rng, h, n):
    """An (h, n, n) float32 bias on the card, as the Coarse and Fine LMs build."""
    return torch.from_numpy(0.5 * rng.standard_normal((h, n, n), dtype=np.float32)).to(DEV)


def flash_bound_ms(q, k, v, bias, mask, *, products=2, adds=0, extra_bytes=0):
    """Least time for the function on these inputs: q, k, v, the bias (the
    table or the (H, N, N) tensor, float32) and the mask read once, out and
    lse written once (plus `extra_bytes`), and `products` matrix products
    (plus `adds` additions) over the attended (q, k) pairs, at the
    tensor-core rate of the input type (3xTF32 for float32). Returns
    (ms, what bounds it)."""
    b, h, n, d = q.shape
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * es + bias.numel() * 4 \
        + b * h * n * 4 + (mask.numel() if mask is not None else 0) + extra_bytes
    keys = torch.ones(b, n, dtype=torch.bool, device=q.device) if mask is None else mask
    # causal: query i attends the valid keys j <= i
    pairs = int(keys.long().cumsum(1).sum()) * h
    flops = (2 * d * products + adds) * pairs
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / (TF32X3_FLOPS if q.dtype == torch.float32 else PEAK_FLOPS[q.dtype]) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_mask(q, tab, mask, bias=None):
    """The float mask SDPA needs for the same function: the expanded table
    (or the (H, N, N) bias), -inf above the diagonal and on masked keys. Its
    rows lie 16 elements apart (a view of a padded buffer), as SDPA's fused
    kernels need for an odd N. Yardstick only."""
    n = q.shape[2]
    fmask = (toeplitz_expand(tab, n, n) if bias is None else bias)[None].to(q.dtype)
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


def check_flash(q, k, v, tab, mask, label, bias=None):
    kw = dict(bias_tab=tab, bias=bias, key_mask=mask, causal=True)
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
    fmask = sdpa_mask(q, tab, mask, bias)
    ke, ve = sdpa_kv(k, v, h)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, ke, ve, attn_mask=fmask))
    bound_ms, bound_by = flash_bound_ms(q, k, v, tab if bias is None else bias, mask)
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
    dq_only_ms = cuda_ms(lambda: fa._bwd_launch("flash_bwd_dq", (dq_out, None, None), *args,
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
    whole_backward(label, dq_ms, dkv_ms, library_ms)
    return result


def whole_backward(label, dq_ms, dkv_ms, library_ms):
    """The port's backward, K2 (with the bias's gradient) + K3, beside SDPA's
    (which computes dq, dk, dv and the float mask's gradient in one call)."""
    ms = dq_ms + dkv_ms
    print(f"flash bwd whole [{label}]: K2 + K3 {dq_ms:.4f} + {dkv_ms:.4f} = {ms:.4f} ms | "
          f"sdpa backward {library_ms:.4f} ms | {library_ms / ms:.2f}x sdpa's speed")


def check_flash_bias_bwd(q, k, v, bias, mask, label, seed):
    """The backward with an (H, N, N) bias through the autograd.Function (K1,
    then K2 with K5 in its launch, and K3) against the plain backward on the
    same out, lse and dO; then each launch alone on prepared arguments.
    plain_ms and library_ms time the whole backward (dq, dk, dv and dbias),
    as for the table form. K5 runs in K2's launch: its row carries that
    launch's time and bound, and the launch is timed once more without
    dbias for K5's share."""
    b, h, n, d = q.shape
    scale = d ** -0.5
    kw = dict(causal=True, scale=scale)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    leaves = [a.detach().requires_grad_() for a in (q, k, v, bias)]
    out, lse = fa.flash_attention(*leaves[:3], bias=leaves[3], key_mask=mask, causal=True,
                                  return_lse=True)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    out, lse = out.detach(), lse.detach()
    ref = fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g, bias=bias, **kw)
    tol = GRAD_TOL[q.dtype]
    errs = {}
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        errs[name] = (a.float() - r.float()).abs().max().item()
        if not torch.allclose(a.float(), r.float(), **tol):
            raise AssertionError(f"flash bias backward vs plain [{label}] {name}: max abs err "
                                 f"{errs[name]} over {tol}")
    if not grads[3].abs().max().item() > 0:
        raise AssertionError(f"flash bias backward [{label}]: dbias is zero")

    delta = (g.float() * out.float()).sum(-1)
    kmask = mask.to(torch.int8).contiguous() if mask is not None else None
    args = (q, k, v, g, lse, delta, None, kmask)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g,
                                                          bias=bias, **kw), iters=3, warmup=1)
    # yardstick only, never called by the port: SDPA forward + backward with the
    # float bias (its gradient included) minus SDPA forward (dk, dv per query head)
    fmask = sdpa_mask(q, None, mask, bias).requires_grad_()
    qs, ks, vs = (a.detach().requires_grad_() for a in (q, *sdpa_kv(k, v, h)))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=fmask)

    fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs, fmask), g), iters=5)
    with torch.no_grad():
        fwd_ms = cuda_ms(sdpa, iters=5)
    library_ms = fwd_bwd_ms - fwd_ms
    es, rows = q.element_size(), b * h * n * 4
    # dq with dbias in one launch: 3 products, one add per pair for the batch
    # sum, dq and dbias written
    dq_ms = cuda_ms(lambda: fa.bwd_dq(*args, bias=bias, **kw))
    dq_bound = flash_bound_ms(q, k, v, bias, mask, products=3, adds=1,
                              extra_bytes=q.numel() * es + rows + bias.numel() * 4)
    dkv_ms = cuda_ms(lambda: fa.bwd_dkv(*args, bias=bias, **kw))
    dkv_bound = flash_bound_ms(q, k, v, bias, mask, products=4,
                               extra_bytes=2 * k.numel() * es + rows)
    # the same launch with the bias read but no dbias output: K2 alone
    dq_out = torch.empty_like(q)
    dq_only_ms = cuda_ms(lambda: fa._bwd_launch("flash_bwd_dq", (dq_out, None, None), *args,
                                                 bias=bias, **kw))
    result = {}
    for name, ms, (bound_ms, bound_by), err in (
            ("dq", dq_ms, dq_bound, errs["dq"]),
            ("dkv", dkv_ms, dkv_bound, max(errs["dk"], errs["dv"])),
            ("dbias", dq_ms, dq_bound, errs["dbias"])):
        result[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms, at=label)
        print(f"flash bias bwd {name} [{label}]: max_abs_err {err:.3e} | kernel {ms:.4f} ms | "
              f"bound {bound_ms:.4f} ms ({bound_by})")
    result["dbias"].update(fused_into="flash_bwd_dq", share_ms=dq_ms - dq_only_ms)
    print(f"flash bias bwd dbias [{label}]: in dq's launch, which takes {dq_only_ms:.4f} ms "
          f"without it: K5's share {dq_ms - dq_only_ms:.4f} ms")
    print(f"flash bias bwd [{label}]: plain backward {plain_ms:.4f} ms | sdpa fwd+bwd - fwd "
          f"{library_ms:.4f} ms ({fwd_bwd_ms:.4f} - {fwd_ms:.4f}) | tol {tol}")
    whole_backward(label, dq_ms, dkv_ms, library_ms)
    return result


def check_masked_tiles(rng, h, d, n=1000):
    """K1-K4 where the key mask reaches the first key tile: batch row 0 with
    keys 0-69 masked (left padding over a whole 64-key tile), row 1 with
    every key masked; causal and not, fp32 and bf16, against the plain
    versions. out and lse must be finite; out is compared on the rows that
    have a key (a causal row with none spreads its weight over the key tiles
    it visits, the plain version over every key; its lse, -1e30, says it is
    empty), lse and dq, dk, dv everywhere."""
    mask = torch.ones(2, n, dtype=torch.bool, device=DEV)
    mask[0, :70] = False
    mask[1] = False
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, tab, _ = flash_inputs(rng, 2, h, n, d, dtype)
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV, dtype)
        for causal in (False, True):
            at = (f"{str(dtype)[6:]} 2x{h}x{n}x{d}, keys < 70 masked in row 0, all in row 1, "
                  f"{'causal' if causal else 'not causal'}")
            kw = dict(bias_tab=tab, key_mask=mask, causal=causal)
            out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
            ref, ref_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
            if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
                raise AssertionError(f"flash kernel [{at}]: out or lse not finite")
            rows = torch.ones(2, n, dtype=torch.bool, device=DEV)
            if causal:
                rows[0, :70] = False
                rows[1] = False
            got, want = (a.float().transpose(1, 2)[rows] for a in (out, ref))
            errs = {"out": (got - want).abs().max().item(),
                    "lse": (lse - ref_lse).abs().max().item()}
            if not (torch.allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])
                    and torch.allclose(lse, ref_lse, rtol=2e-3, atol=2e-3)):
                raise AssertionError(f"flash kernel vs plain [{at}]: {errs}")
            bkw = dict(causal=causal, scale=d ** -0.5)
            grads = fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, **bkw)
            ref = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, **bkw)
            for name, a, r in zip(("dq", "dk", "dv", "dtab"), grads, ref):
                errs[name] = (a.float() - r.float()).abs().max().item()
                if not torch.allclose(a.float(), r.float(), **GRAD_TOL[dtype]):
                    raise AssertionError(f"flash backward vs plain [{at}] {name}: max abs err "
                                         f"{errs[name]} over {GRAD_TOL[dtype]}")
            print(f"masked tiles [{at}]: finite, max abs err "
                  + " ".join(f"{x} {e:.3e}" for x, e in errs.items()))


def check_bias_form(rng, b, h, n, d, label, seed, **mask_kw):
    """K1-K3, K5 in K2's launch, with an (h, n, n) bias, fp32 and bf16:
    {"fp32": rows, "bf16": rows}."""
    rows = {}
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        q, k, v, _, mask = flash_inputs(rng, b, h, n, d, dtype, **mask_kw)
        bias = dense_bias(rng, h, n)
        at = f"{name} {b}x{h}x{n}x{d} {label}, (H, N, N) bias"
        fwd = check_flash(q, k, v, None, mask, at, bias=bias)
        bwd = check_flash_bias_bwd(q, k, v, bias, mask, at, seed)
        rows[name] = {"fwd": fwd, **bwd}
    return rows


@phase("kernels")
def kernel_phase(seed):
    rng = np.random.default_rng(seed)
    h, d = FLAGSHIP["heads"], FLAGSHIP["dim_head"]
    main = check_flash(*flash_inputs(rng, 4, h, 2048, d, torch.float32), "fp32 4x8x2048x64")
    main_bf16 = check_flash(*flash_inputs(rng, 4, h, 2048, d, torch.bfloat16),
                            "bf16 4x8x2048x64")
    train = f"{TRAIN_IDS[0]}x{h}x{TRAIN_N}x{d} (training), 15% of keys forgotten"
    check_flash(*flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, torch.float32, forget_p=0.15),
                f"fp32 {train}")
    check_flash(*flash_inputs(rng, 2, h, 1000, d, torch.float32, key_mask_from=700),
                "fp32 ragged 2x8x1000x64, keys >= 700 masked in row 1")
    check_flash(*flash_inputs(rng, 2, h, 1000, d, torch.bfloat16, key_mask_from=700),
                "bf16 ragged 2x8x1000x64, keys >= 700 masked in row 1")
    bwd = check_flash_bwd(*flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, torch.float32,
                                        forget_p=0.15), f"fp32 {train}", seed)
    bwd_bf16 = check_flash_bwd(*flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, torch.bfloat16,
                                             forget_p=0.15), f"bf16 {train}", seed)
    check_flash_bwd(*flash_inputs(rng, 4, h, 2048, d, torch.float32, forget_p=0.15),
                    "fp32 4x8x2048x64, 15% of keys forgotten", seed)
    check_flash_bwd(*flash_inputs(rng, 4, h, 2048, d, torch.bfloat16, forget_p=0.15),
                    "bf16 4x8x2048x64, 15% of keys forgotten", seed)
    check_flash_bwd(*flash_inputs(rng, 2, h, 1000, d, torch.float32, key_mask_from=700),
                    "fp32 ragged 2x8x1000x64, keys >= 700 masked in row 1", seed)
    check_flash_bwd(*flash_inputs(rng, 2, h, 1000, d, torch.bfloat16, key_mask_from=700),
                    "bf16 ragged 2x8x1000x64, keys >= 700 masked in row 1", seed)
    check_masked_tiles(rng, h, d)
    # the (H, N, N)-bias form: the Coarse and Fine training shapes, and a ragged one
    coarse = check_bias_form(rng, CLIP_B, h, COARSE_N, d,
                             "(Coarse training), 15% of keys forgotten", seed, forget_p=0.15)
    bias = check_bias_form(rng, CLIP_B, h, FINE_N, d, "(Fine training), 15% of keys forgotten",
                           seed, forget_p=0.15)
    check_bias_form(rng, 2, h, 1000, d, "ragged, keys >= 700 masked in row 1", seed,
                    key_mask_from=700)
    # fp32 rows, with bf16 and the Coarse shape's beside them
    return {"fwd": main, **bwd, "bias": bias["fp32"],
            "bf16": {"fwd": main_bf16, **bwd_bf16, "bias": bias["bf16"]},
            "coarse": coarse}


@phase("sass")
def sass_phase():
    """HMMA (tensor-core) and FFMA instructions of each kernel in the built
    libraries' SASS (cuobjdump -sass). K1, K2 (both instantiations: with
    K5's sum and without), K3 and K7 must issue HMMA in both dtypes, K6 (in
    float32 only) too. Returns {"fwd": {dtype: HMMA}, "dq": {...}, ...}."""
    kernels = (("fwd", "flash_fwd_kernel"), ("dq", "flash_bwd_dq_kernel"),
               ("dkv", "flash_bwd_dkv_kernel"), ("vq", "vq_nearest_kernel"),
               ("local", "local_attn_kernel"))
    want = {"fwd": ["bf16", "fp32"], "dq": ["bf16", "bf16, sum", "fp32", "fp32, sum"],
            "dkv": ["bf16", "fp32"], "vq": ["fp32"], "local": ["bf16", "fp32"]}
    result = {key: {} for key, _ in kernels}
    for src in SOURCES:
        for mangled, ops in sorted(_build.sass_counts(src).items(), key=lambda x: x[0]):
            label = kernel_label(mangled)
            print(f"sass {label}: HMMA {ops['HMMA']} FFMA {ops['FFMA']}")
            for key, kernel in kernels:
                if label == kernel:  # not a template: float32 only
                    result[key]["fp32"] = ops["HMMA"]
                elif label.startswith(kernel + "<"):
                    result[key][label[len(kernel) + 1:-1]] = ops["HMMA"]
    for key, by_dtype in result.items():
        if sorted(by_dtype) != want[key] or not all(by_dtype.values()):
            raise AssertionError(f"{key}: tensor-core instructions by dtype {by_dtype}")
    return result


def attention_f64(q, k, v, tab, bias, mask, g, scale):
    """Causal attention in float64, by the plain versions on float64 inputs:
    out, lse, Delta and the dq, dk, dv and the bias's gradient of dO = g (the
    query heads of each kv head summed)."""
    q, k, v, g = (a.double() for a in (q, k, v, g))
    tab, bias = (None if a is None else a.double() for a in (tab, bias))
    out, lse = fa.flash_attention_ref(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                      causal=True, scale=scale, return_lse=True)
    dq, dk, dv, dgrad = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, causal=True,
                                                   scale=scale, bias=bias)
    return out, lse, (g * out).sum(-1), dq, dk, dv, dgrad


def rel_err(a, ref):
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


def f64_errors(q, k, v, tab, bias, mask, g, ref, scale):
    """K1's out, and K2's dq (with a bias its dbias) and K3's dk and dv fed
    the float64 lse and Delta, against the float64 reference: max |kernel -
    ref| / max |ref| of each (the table's gradient is held to the plain
    version in the kernels phase)."""
    out64, lse64, delta64, dq64, dk64, dv64, dgrad64 = ref
    out = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, key_mask=mask, causal=True)
    kmask = mask.to(torch.int8).contiguous() if mask is not None else None
    bargs = (q, k, v, g, lse64.float(), delta64.float(), tab, kmask)
    dq, dgrad = fa.bwd_dq(*bargs, causal=True, scale=scale, bias=bias)
    dk, dv = fa.bwd_dkv(*bargs, causal=True, scale=scale, bias=bias)
    errs = {"out": rel_err(out, out64), "dq": rel_err(dq, dq64), "dk": rel_err(dk, dk64),
            "dv": rel_err(dv, dv64)}
    if bias is not None:
        errs["dbias"] = rel_err(dgrad, dgrad64)
    return errs


@phase("tf32")
def accuracy_phase(seed):
    """float32 on the tensor cores: K1's output, K2's dq (and with the bias
    its dbias) and K3's dk, dv within F64_TOL of a float64 evaluation at the
    Semantic training shape (the table) and the Fine one (an (H, N, N) bias,
    B = 4), with 15% of the keys forgotten; the same check must reject the
    1xTF32 build. Then K3's dk and dv and K2's dq and K4's dtab at the
    Semantic shape, and K2's dq and dbias at the Fine one, must be the same
    bits over three runs (fp32 and bf16)."""
    rng = np.random.default_rng(seed + 7)
    h, d = FLAGSHIP["heads"], FLAGSHIP["dim_head"]
    scale = d ** -0.5
    result = {}
    for label, n, dense in (("table", TRAIN_N, False), ("bias", FINE_N, True)):
        b = TRAIN_IDS[0] if not dense else CLIP_B
        q, k, v, tab, mask = flash_inputs(rng, b, h, n, d, torch.float32, forget_p=0.15)
        bias = dense_bias(rng, h, n) if dense else None
        tab = None if dense else tab
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV)
        ref = attention_f64(q, k, v, tab, bias, mask, g, scale)
        args = (q, k, v, tab, bias, mask, g, ref, scale)
        three = f64_errors(*args)
        with fa.built_with(ONE_PASS):
            one = f64_errors(*args)
        at = f"fp32 {b}x{h}x{n}x{d} {label}"
        print(f"tf32 [{at}]: 3xTF32 vs float64 "
              + " ".join(f"{x} {e:.2e}" for x, e in three.items())
              + f" (limit {F64_TOL}) | 1xTF32 " + " ".join(f"{x} {e:.2e}" for x, e in one.items()))
        if max(three.values()) > F64_TOL:
            raise AssertionError(f"3xTF32 vs float64 [{at}]: {three} over {F64_TOL}")
        if min(one.values()) <= F64_TOL:
            raise AssertionError(f"the float64 check let the 1xTF32 build through [{at}]: {one}")
        print(f"tf32 [{at}]: the 1xTF32 build is rejected")
        result[label] = {"3xtf32": three, "1xtf32": one}
        del ref, args
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, tab, mask = flash_inputs(rng, TRAIN_IDS[0], h, TRAIN_N, d, dtype, forget_p=0.15)
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV, dtype)
        out, lse = fa.flash_attention(q, k, v, bias_tab=tab, key_mask=mask, causal=True,
                                      return_lse=True)
        bargs = (q, k, v, g, lse, (g.float() * out.float()).sum(-1), tab,
                 mask.to(torch.int8).contiguous())
        for name, fn in (("K3 dk, dv", fa.bwd_dkv), ("K2 dq, K4 dtab", fa.bwd_dq)):
            first = fn(*bargs, causal=True, scale=scale)
            for _ in range(2):
                again = fn(*bargs, causal=True, scale=scale)
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"{name} differ between runs ({dtype})")
            print(f"tf32: {name} bitwise equal over 3 runs ({str(dtype)[6:]}, "
                  f"{TRAIN_IDS[0]}x{h}x{TRAIN_N}x{d})")
        # K2 with K5: B = 4 is one cluster, so dbias is summed in rank order
        q, k, v, _, mask = flash_inputs(rng, CLIP_B, h, FINE_N, d, dtype, forget_p=0.15)
        bias = dense_bias(rng, h, FINE_N)
        g = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)).to(DEV, dtype)
        out, lse = fa.flash_attention(q, k, v, bias=bias, key_mask=mask, causal=True,
                                      return_lse=True)
        bargs = (q, k, v, g, lse, (g.float() * out.float()).sum(-1), None,
                 mask.to(torch.int8).contiguous())
        first = fa.bwd_dq(*bargs, causal=True, scale=scale, bias=bias)
        for _ in range(2):
            again = fa.bwd_dq(*bargs, causal=True, scale=scale, bias=bias)
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"K2 dq/dbias differ between runs ({dtype})")
        print(f"tf32: K2 dq, dbias bitwise equal over 3 runs ({str(dtype)[6:]}, "
              f"{CLIP_B}x{h}x{FINE_N}x{d}, (H, N, N) bias)")
    result.update(codec_accuracy(rng))
    return result


def local_f64_error(q, k, v, w, mask, bias, scale=8.0 / 64):
    """max |K7 - float64| / max |float64| for float32 q, k, v; the float64
    evaluation is the plain version's on float64 inputs."""
    ref = la.local_attention_ref(q.double(), k.double(), v.double(), window_size=w, mask=mask,
                                 attn_bias=None if bias is None else bias.double(), scale=scale)
    return rel_err(la.local_attention(q, k, v, window_size=w, mask=mask, attn_bias=bias,
                                      scale=scale), ref)


def codec_accuracy(rng):
    """The codec's kernels in float32 on the tensor cores: K7's output within
    F64_TOL of a float64 evaluation at the codec's shape, at 10 s and a
    ragged, key-masked, biased shape, the plain-TF32 build shown to fail the
    same check; K6 on near ties at the codec's shape (every row's two best
    codes 1.5e-5 to 4e-5 of the score's terms apart) within the near-tie
    gate, the plain-TF32 build shown to fail it; K6's indices the same bits
    over three runs."""
    result = {"local": {}}
    cases = (("8x8x100x64 w128 (codec)", (8, 8, 100, 64, torch.float32, 128)),
             ("8x8x500x64 w128 (10 s)", (8, 8, 500, 64, torch.float32, 128)),
             ("ragged 2x8x300x64 w64, key mask, bias", (2, 8, 300, 64, torch.float32, 64)))
    for label, shape in cases:
        ragged = shape[-1] == 64
        q, k, v, mask, bias = local_inputs(rng, *shape, masked=ragged, biased=ragged)
        three = local_f64_error(q, k, v, shape[-1], mask, bias)
        with _build.built_with(ONE_PASS):
            one = local_f64_error(q, k, v, shape[-1], mask, bias)
        print(f"tf32 [K7 fp32 {label}]: 3xTF32 vs float64 {three:.2e} (limit {F64_TOL}) | "
              f"1xTF32 {one:.2e}")
        if three > F64_TOL:
            raise AssertionError(f"K7 3xTF32 vs float64 [{label}]: {three} over {F64_TOL}")
        if one <= F64_TOL:
            raise AssertionError(f"the float64 check let K7's 1xTF32 build through [{label}]")
        result["local"][label] = {"3xtf32": three, "1xtf32": one}
    x, cb = vq_near_ties(rng)
    label = f"{x.shape[0]}x512 vs 1024x512 (codec), every row a near tie"
    _, differ, _, rel = vq_gate(x, cb, label)
    with _build.built_with(ONE_PASS):
        _, differ1, _, rel1 = vq_gate(x, cb, label)
    print(f"tf32 [K6 {label}]: 3xTF32 {differ} rows differ from the plain version, relative gap "
          f"up to {rel:.2e} (near-tie limit {NEAR_TIE}) | 1xTF32 {differ1} rows, up to {rel1:.2e}")
    if rel >= NEAR_TIE:
        raise AssertionError(f"K6 3xTF32 [{label}]: relative gap {rel} over {NEAR_TIE}")
    if rel1 < NEAR_TIE:
        raise AssertionError(f"the near-tie gate let K6's 1xTF32 build through [{label}]")
    result["vq"] = {"3xtf32": {"rows": differ, "rel_gap": rel},
                    "1xtf32": {"rows": differ1, "rel_gap": rel1}}
    x, cb = vq_inputs(rng, CODEC_B * CODEC_S * HZ)
    first = vq.vq_nearest_code(x, cb)
    if not all(torch.equal(vq.vq_nearest_code(x, cb), first) for _ in range(2)):
        raise AssertionError("K6's indices differ between runs")
    print("tf32: K6 indices bitwise equal over 3 runs (800x512 vs 1024x512)")
    return result


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
    share of the call's wall time the device was busy: (busy ms, wall ms,
    [(ms, launches, kernel name)])."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in kernel_events(prof)]
    busy = sum(r[0] for r in rows)
    print(f"{label} profile: device busy {busy:.2f} ms of {wall_ms:.2f} ms "
          f"wall under the profiler ({100 * (1 - busy / wall_ms):.1f}% idle)")
    for ms, count, name in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:8.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} {name[:90]}")
    return busy, wall_ms, rows


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
        # the table form: K1-K4, no K5; no codec kernel
        want = depth * steps if name in ("launches", "launches_dq", "launches_dkv",
                                         "launches_dtab") else 0
        if n != want:
            raise AssertionError(f"training: {name} {n} != {want}")
    if not all(np.isfinite([first, *losses])):
        raise AssertionError(f"non-finite training loss: {[first, *losses]}")
    if not losses[-1] < first:
        raise AssertionError(f"training loss did not fall: {[first, *losses]}")
    print(f"training 4x2048, lr 3e-4, clip 0.5: losses {first:.4f} (warm) "
          + " ".join(f"{x:.4f}" for x in losses)
          + f" | {step_ms:.2f} ms per step ({ids.numel() / step_ms * 1e3:.0f} tokens/s) | "
          f"max_memory_allocated {peak / 2**30:.3f} GiB | launches {launched}")

    # card vs CPU gradients at 1 x 256, same weights, same forgetful mask
    check_card_grads("training 1x256", SemanticTransformerWrapper, model, (ids[:1, :256],), seed,
                     ("bwd_dq", 0, "dq"), FLAGSHIP["depth"])
    profile("training (one 4x2048 step)", lambda: trainer.step(ids), top=12)
    return launched


def check_card_grads(label, wrapper, model, batch, seed, fault, depth):
    """The card's parameter gradients of the train loss on `batch` against
    the CPU port's on the same weights and forgetful mask, worst leaf by
    relative norm within LEAF_TOL; then the same comparison must reject the
    card's gradients with `fault` = (wrapper function of the flash module,
    the index of its output, the output's name) zeroed in one layer's
    backward."""
    card = small_grads(wrapper, model, batch, seed)
    cpu = small_grads(wrapper, copy.deepcopy(model).cpu(), tuple(a.cpu() for a in batch), seed)
    errs = leaf_errors(card, cpu)
    worst = max(errs, key=errs.get)
    top = max(cpu, key=lambda n: cpu[n].abs().max())
    print(f"{label} card (kernels) vs CPU (plain) gradients: worst of {len(errs)} of "
          f"{len(cpu)} leaves {errs[worst]:.3e} in {worst} (limit {LEAF_TOL}); largest "
          f"|g| {cpu[top].abs().max().item():.3e} in {top}")
    if errs[worst] > LEAF_TOL:
        raise AssertionError(f"{label}: card vs CPU gradient of {worst}: {errs[worst]:.3e} > "
                             f"{LEAF_TOL}")
    # the comparison must see a wrong layer
    layer = depth // 2
    faulty = leaf_errors(small_grads(wrapper, model, batch, seed, zero=(*fault[:2], layer)), cpu)
    bad = max(faulty, key=faulty.get)
    print(f"{label} with {fault[2]} zeroed in backward call {layer} of {depth}: worst leaf "
          f"{faulty[bad]:.3e} in {bad}, {sum(e > LEAF_TOL for e in faulty.values())} leaves "
          f"over the limit: rejected")
    if faulty[bad] <= LEAF_TOL:
        raise AssertionError(f"{label}: the card vs CPU gradient check let a zeroed "
                             f"{fault[2]} through")


def small_grads(wrapper, model, batch, seed, zero=None):
    """{name: gradient on the CPU} of the train loss of `batch` under the
    forgetful mask drawn from `seed`; with zero = (name, index, call), output
    `index` of the flash module's function `name` (bwd_dq: 0 dq, 1 the bias's
    gradient) in that backward call (1 = the last layer) is zeroed."""
    calls = [0]
    if zero is not None:
        name, index, call = zero
        real = getattr(fa, name)

        def faulty(*args, **kw):
            out = real(*args, **kw)
            calls[0] += 1
            if calls[0] != call:
                return out
            return tuple(torch.zeros_like(o) if i == index else o for i, o in enumerate(out))

        setattr(fa, name, faulty)
    try:
        model.zero_grad(set_to_none=True)
        wrapper(transformer=model)(*batch, return_loss=True, train=True,
                                   generator=torch.Generator().manual_seed(seed)).backward()
    finally:
        if zero is not None:
            setattr(fa, name, real)
    if zero is not None and calls[0] < call:
        raise AssertionError(f"backward made {calls[0]} {name} launches, not {call}")
    # every parameter, zero where the loss does not reach it
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
            for n, p in model.named_parameters()}


def leaf_errors(got, ref):
    """{name: ||got - ref|| / ||ref||} over the leaves whose `ref` norm is
    over 1e-6 of the largest leaf's."""
    top = max(g.norm().item() for g in ref.values())
    return {n: ((got[n] - r).norm() / r.norm()).item() for n, r in ref.items()
            if r.norm().item() > 1e-6 * top}


LMS = {"coarse": (CoarseTransformer, COARSE, CoarseTransformerWrapper),
       "fine": (FineTransformer, FINE, FineTransformerWrapper)}


def acoustic_model(kind, seed):
    """The Coarse or Fine LM on the CPU, weights from `seed`, with the
    dynamic hyper-connection weights and the Coarse LM's cross_attn_bias
    (zero at init) made to count."""
    cls, cfg, _ = LMS[kind]
    model = cls(**cfg, seed=seed, device="cpu").eval()
    rng = np.random.default_rng(seed + 5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("dyn_alpha_w", "dyn_beta_w", "cross_attn_bias")):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape, dtype=np.float32)))
    return model


def acoustic_batch(kind, rng, b, seconds, device=DEV):
    """The wrapper's batch of b clips: the Coarse LM's semantic ids (without
    consecutive repeats, so unique-consecutive keeps them all) and coarse
    codes, or the Fine LM's coarse and fine codes, at 50 Hz."""
    frames = seconds * HZ
    if kind == "coarse":
        vocab = COARSE["num_semantic_tokens"]
        sem = np.cumsum(rng.integers(1, vocab, (b, frames)), axis=1) % vocab
        ids = (sem, rng.integers(0, 1024, (b, frames * 3)))
    else:
        ids = (rng.integers(0, 1024, (b, frames * 3)), rng.integers(0, 1024, (b, frames * 5)))
    return tuple(torch.from_numpy(a).to(device) for a in ids)


def acoustic_scoring(kind, seed, model, cpu_model):
    """The eval loss of 4 x 3-s clips: ms per call and tokens/s; the card's
    logits against the CPU port's on a 1-s clip."""
    wrapper = LMS[kind][2](transformer=model)
    batch = acoustic_batch(kind, np.random.default_rng(seed + 6), CLIP_B, CLIP_S)
    depth = ACOUSTIC["depth"]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with torch.no_grad():
        loss = wrapper(*batch, return_loss=True)
        torch.cuda.synchronize()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            wrapper(*batch, return_loss=True)
        torch.cuda.synchronize()
        score_ms = (time.perf_counter() - t0) / iters * 1e3
    launched = counts()
    calls = 1 + iters
    if launched["launches"] != depth * calls or launched["launches_dbias"]:
        raise AssertionError(f"{kind} scoring launches {launched} != depth {depth} x {calls}")
    if not torch.isfinite(loss):
        raise AssertionError(f"{kind} scoring: non-finite loss {loss.item()}")
    tokens = sum(a.numel() for a in batch)
    print(f"{kind} scoring {CLIP_B}x{CLIP_S}s ({tokens} ids): loss {loss.item():.4f} | "
          f"{score_ms:.2f} ms per call ({tokens / score_ms * 1e3:.0f} tokens/s) | "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | "
          f"flash launches {launched['launches']} = {depth} x {calls}")
    small = acoustic_batch(kind, np.random.default_rng(seed + 7), 1, 1)
    with torch.no_grad():
        card = [x.cpu() for x in wrapper(*small) if x is not None]
        cpu = [x for x in LMS[kind][2](transformer=cpu_model)(*(a.cpu() for a in small))
               if x is not None]
    err = max((a - r).abs().max().item() for a, r in zip(card, cpu))
    if not all(torch.allclose(a, r, rtol=LOGITS_TOL, atol=LOGITS_TOL) for a, r in zip(card, cpu)):
        raise AssertionError(f"{kind} card vs CPU logits on a 1-s clip: max abs err {err}")
    print(f"{kind} scoring 1x1s card (flash kernels) vs CPU (plain): max abs err {err:.3e} "
          f"(tol {LOGITS_TOL})")
    return launched


def check_cached_logits(label, logits, full, n):
    err = (logits[:, :n] - full[:, :n]).abs().max().item()
    if not torch.allclose(logits[:, :n], full[:, :n], rtol=LOGITS_TOL, atol=LOGITS_TOL):
        raise AssertionError(f"{label}: cached vs uncached logits max abs err {err}")
    return err


def coarse_generation(seed, model):
    """Greedy coarse codes of a 1-s clip, batch 1: 50 semantic ids -> 150
    codes (fewer if EOS comes first); each code's logits against an uncached
    scoring. Returns the launch counts and the (1, 50, 3) grid."""
    wrapper = CoarseTransformerWrapper(transformer=model)
    rng = np.random.default_rng(seed + 8)
    vocab = COARSE["num_semantic_tokens"]
    sem = torch.from_numpy(np.cumsum(rng.integers(1, vocab, (1, HZ)), axis=1) % vocab).to(DEV)
    kw = dict(semantic_token_ids=sem, max_time_steps=HZ, temperature=1e-10,
              generator=torch.Generator(device=DEV).manual_seed(seed))
    zero_counts()
    grid, logits = wrapper.generate(**kw, return_logits=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrapper.generate(**kw)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launched = counts()  # the cached prefill and decode steps take `attend`
    codes = grid.reshape(1, -1)
    n = int((codes >= 0).sum())
    with torch.no_grad():
        _, full = model(sem, codes.clamp(min=0))
    # up to the first EOS, whose logits were sampled too
    err = check_cached_logits("coarse generation", logits, full, min(n + 1, codes.shape[1]))
    print(f"coarse generation b1 {HZ} semantic ids -> {n} codes: {gen_s * 1e3:.1f} ms, "
          f"{n / gen_s:.1f} codes/s | cached vs uncached logits max abs err {err:.3e} "
          f"(tol {LOGITS_TOL}) | kernel launches {launched}")
    return launched, grid


def fine_generation(seed, model, coarse_grid):
    """Greedy fine codes of the coarse grid, batch 1: 50 x 5 = 250 codes;
    each code's logits against an uncached scoring."""
    wrapper = FineTransformerWrapper(transformer=model)
    kw = dict(coarse_token_ids=coarse_grid, temperature=1e-10,
              generator=torch.Generator(device=DEV).manual_seed(seed))
    zero_counts()
    grid, logits = wrapper.generate(**kw, return_logits=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wrapper.generate(**kw)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launched = counts()
    codes = grid.reshape(1, -1)
    with torch.no_grad():
        _, full = model(coarse_grid, codes[:, :-1])
    err = check_cached_logits("fine generation", logits, full, codes.shape[1])
    print(f"fine generation b1 {coarse_grid.shape[1]} time steps -> {codes.shape[1]} codes: "
          f"{gen_s * 1e3:.1f} ms, {codes.shape[1] / gen_s:.1f} codes/s | cached vs uncached "
          f"logits max abs err {err:.3e} (tol {LOGITS_TOL}) | kernel launches {launched}")
    return launched


def acoustic_training(kind, seed, cpu_model):
    """The train step on 4 x 3-s clips: warm step, five timed steps, then
    the card's gradients against the CPU port's on a 1-s clip and the check
    shown to reject K2's dbias (K5) zeroed in one layer, then one profiled
    step."""
    wrapper = LMS[kind][2]
    model = copy.deepcopy(cpu_model).train()
    trainer = TransformerTrainStep(wrapper(transformer=model), device=DEV)
    batch = acoustic_batch(kind, np.random.default_rng(seed + 9), CLIP_B, CLIP_S)
    first = trainer.step(*batch)  # warm step
    depth, steps = ACOUSTIC["depth"], 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    losses = [trainer.step(*batch) for _ in range(steps)]  # .item() in each step syncs
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    launched = counts()
    peak = torch.cuda.max_memory_allocated()
    # K5 runs inside each K2 launch: the backward is K2 and K3, depth times each
    want = dict(launches=depth * steps, launches_dq=depth * steps, launches_dkv=depth * steps,
                launches_dtab=0, launches_dbias=depth * steps, launches_vq=0, launches_local=0)
    if launched != want:
        raise AssertionError(f"{kind} training launches {launched} != {want}")
    if not all(np.isfinite([first, *losses])):
        raise AssertionError(f"{kind}: non-finite training loss: {[first, *losses]}")
    if not losses[-1] < first:
        raise AssertionError(f"{kind}: training loss did not fall: {[first, *losses]}")
    tokens = sum(a.numel() for a in batch)
    print(f"{kind} training {CLIP_B}x{CLIP_S}s, lr 3e-4, clip 0.5: losses {first:.4f} (warm) "
          + " ".join(f"{x:.4f}" for x in losses)
          + f" | {step_ms:.2f} ms per step ({tokens / step_ms * 1e3:.0f} tokens/s) | "
          f"max_memory_allocated {peak / 2**30:.3f} GiB | launches {launched}")
    small = acoustic_batch(kind, np.random.default_rng(seed + 10), 1, 1)
    check_card_grads(f"{kind} training 1x1s", wrapper, model, small, seed, ("bwd_dq", 1, "dbias"),
                     depth)
    profile(f"{kind} training (one {CLIP_B}x{CLIP_S}s step)", lambda: trainer.step(*batch),
            top=12)
    return launched


# the codec at bench.py's width (bench.py:134, `bench_codec`): AudioLMSoundStream(
# codebook_size=1024), channels 32, codebook dim 512, 12 quantizers, window 128, 8
# heads of 64, on 8 clips of 2 s at 16 kHz (50 frames a second)
SR = 16000
CODEC_B, CODEC_S = 8, 2
# K6 against its plain version: indices identical but where the two codes'
# float64 scores differ by under this share of the score's terms
# (|e|^2 + 2 |x| |e|): there the kernel's summation order may pick the other
NEAR_TIE = 1e-5
# card vs CPU waveforms, max |card - cpu| over the CPU waveform's peak. The
# codec phase prints the CPU's own spread beside it (the same decode with 1
# thread and with all): about 1e-6 of the peak at this width, so the limit
# leaves cuDNN's other algorithms and summation orders two decades
WAVE_REL_TOL = 1e-4


def vq_inputs(rng, n, c=1024, d=512, dup=False):
    """x (n, d) and a codebook (c, d) on the card: rows near random codes (a
    residual near its code), 30% far from any; with dup, codebook rows 1,
    c // 2 and c - 1 copies of row 0 and x[0] near row c // 2 (a tie)."""
    cb = rng.standard_normal((c, d), dtype=np.float32)
    if dup:
        cb[[1, c // 2, c - 1]] = cb[0]
    near = rng.integers(0, c, n)
    near[0] = c // 2
    x = cb[near] + 0.3 * rng.standard_normal((n, d), dtype=np.float32)
    far = rng.random(n) < 0.3
    far[0] = False
    x[far] = rng.standard_normal((int(far.sum()), d), dtype=np.float32)
    return torch.from_numpy(x).to(DEV), torch.from_numpy(cb).to(DEV)


def vq_scores(x, cb, idx):
    """float64 -2 x.e + |e|^2 of code idx[i] for row i, and the terms' size."""
    xd, ed = x.double(), cb.double()[idx.long()]
    e2 = ed.square().sum(-1)
    return e2 - 2 * (xd * ed).sum(-1), e2 + 2 * xd.norm(dim=-1) * ed.norm(dim=-1)


def vq_near_ties(rng, n=CODEC_B * CODEC_S * HZ, c=1024, d=512):
    """x (n, d) and a codebook (c, d) on the card, at the codec's shape, with
    every row a near tie: near the midpoint of two random codes a and b,
    moved along a - b until their float64 scores differ by 1.5e-5 to 4e-5 of
    the score's terms (either one lower); every other code far. The plain
    version's float32 picks the lower; plain TF32 errs by ~1e-5 of the terms."""
    cb = rng.standard_normal((c, d), dtype=np.float32)
    a = rng.integers(0, c, n)
    b = (a + rng.integers(1, c, n)) % c
    ea, eb = cb[a].astype(np.float64), cb[b].astype(np.float64)
    x0 = (ea + eb) / 2 + 0.3 * rng.standard_normal((n, d))
    diff = ea - eb
    size = (ea * ea).sum(-1) + 2 * np.linalg.norm(x0, axis=-1) * np.linalg.norm(ea, axis=-1)
    gap = rng.uniform(1.5e-5, 4e-5, n) * size * rng.choice([-1.0, 1.0], n)
    shift = ((ea * ea).sum(-1) - (eb * eb).sum(-1) - 2 * (x0 * diff).sum(-1) - gap) \
        / (2 * (diff * diff).sum(-1))
    x = (x0 + shift[:, None] * diff).astype(np.float32)
    return torch.from_numpy(x).to(DEV), torch.from_numpy(cb).to(DEV)


def vq_gate(x, cb, label):
    """K6's picks against its plain version's: (rows that differ, largest
    float64 score gap between the two picks, the same over the score's
    terms; both 0 when identical)."""
    got = vq.vq_nearest_code(x, cb)
    torch.cuda.synchronize()
    ref = vq.vq_nearest_code_ref(x, cb)
    if got.dtype != torch.int32 or got.shape != ref.shape:
        raise AssertionError(f"K6 [{label}]: {got.dtype} {tuple(got.shape)}")
    diff = (got != ref).nonzero().flatten()
    if not len(diff):
        return got, 0, 0.0, 0.0
    sa, mag = vq_scores(x[diff], cb, got[diff])
    sb, _ = vq_scores(x[diff], cb, ref[diff])
    return got, len(diff), (sa - sb).abs().max().item(), ((sa - sb).abs() / mag).max().item()


def check_vq(x, cb, label, want_first=None):
    """K6 against its plain version: identical indices but near ties
    (counted); one device launch a call; its time (by CUDA events and on the
    device), the plain version's, the library call's (with |e|^2 summed in
    the call and given) and the bound. max_abs_err is the largest float64
    score gap between the two picks (0 when identical)."""
    got, differ, gap, rel = vq_gate(x, cb, label)
    if rel >= NEAR_TIE:
        raise AssertionError(f"K6 vs plain [{label}]: {differ} rows differ, relative "
                             f"score gap up to {rel:.3e} (near-tie limit {NEAR_TIE})")
    if want_first is not None and not (got[: len(want_first)].cpu() == want_first).all():
        raise AssertionError(f"K6 [{label}]: ties did not go to the first index: "
                             f"{got[: len(want_first)].tolist()}")
    n, d = x.shape
    c = cb.shape[0]
    e2 = cb.square().sum(-1)
    ms = cuda_ms(lambda: vq.vq_nearest_code(x, cb), iters=20)
    dev_ms, dev_launches, dev_names = device_per_call(lambda: vq.vq_nearest_code(x, cb))
    if dev_launches != 1 or not all("vq_nearest_kernel" in k for k in dev_names):
        raise AssertionError(f"K6 [{label}]: not one device launch a call: {dev_names}")
    plain_ms = cuda_ms(lambda: vq.vq_nearest_code_ref(x, cb), iters=20)

    # yardsticks only, never called by the port: addmm + argmin with |e|^2
    # summed inside the timed call (the function the wrapper computes) and
    # with |e|^2 given
    def library():
        return torch.argmin(torch.addmm(cb.square().sum(-1), x, cb.t(), alpha=-2), -1)

    def library_e2_given():
        return torch.argmin(torch.addmm(e2, x, cb.t(), alpha=-2), -1)

    library_ms = cuda_ms(library, iters=20)
    library_e2_given_ms = cuda_ms(library_e2_given, iters=20)
    library_dev_ms = device_per_call(library)[0]
    library_e2_given_dev_ms = device_per_call(library_e2_given)[0]
    # the products at the 3xTF32 rate (the kernel's), and at the FMA rate
    t_ops = 2 * n * c * d / TF32X3_FLOPS * 1e3
    t_bytes = 4 * (n * d + c * d + n) / HBM_BPS * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    bound_fma_ms = max(2 * n * c * d / PEAK_FLOPS[torch.float32] * 1e3, t_bytes)
    print(f"vq [{label}]: {differ} near-tie rows differ (score gap {gap:.3e}) | kernel "
          f"{ms:.4f} ms, on the device {dev_ms:.4f} ms in {dev_launches:g} launch per call | "
          f"plain {plain_ms:.4f} ms | addmm+argmin {library_ms:.4f} ms (device "
          f"{library_dev_ms:.4f}), |e|^2 given {library_e2_given_ms:.4f} ms (device "
          f"{library_e2_given_dev_ms:.4f}) | bound {bound_ms:.4f} ms ({bound_by}; at the FMA "
          f"rate {bound_fma_ms:.4f} ms)")
    return dict(max_abs_err=gap, near_ties=differ, ms=ms, device_ms=dev_ms,
                device_launches=dev_launches, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                library_device_ms=library_dev_ms, library_e2_given_ms=library_e2_given_ms,
                library_e2_given_device_ms=library_e2_given_dev_ms, at=label)


def local_inputs(rng, b, h, t, d, dtype, w, masked=False, biased=False):
    """q, k, v (b, h, t, d) on the card; with masked, row 0's keys from 2t/3
    on and 20% of row 1's masked (key 0 kept); with biased, an (h, w, 2w)
    float32 bias."""
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d), dtype=np.float32)).to(DEV, dtype)
               for _ in range(3))
    mask = bias = None
    if masked:
        m = np.ones((b, t), bool)
        m[0, (2 * t) // 3:] = False
        m[-1, rng.random(t) < 0.2] = False
        m[:, 0] = True
        mask = torch.from_numpy(m).to(DEV)
    if biased:
        bias = torch.from_numpy(0.3 * rng.standard_normal((h, w, 2 * w), dtype=np.float32)).to(DEV)
    return q, k, v, mask, bias


def local_views(rng, b, h, t, d, dtype):
    """q, k, v as LocalMHA hands them to K7: (b, h, t, d) views of the three
    chunks of one (b, t, 3 h d) projection; the kernel must read them in
    place."""
    qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * h * d), dtype=np.float32))
    views = [a.reshape(b, t, h, d).transpose(1, 2) for a in qkv.to(DEV, dtype).chunk(3, dim=-1)]
    if any(la._readable(a) is not a for a in views):
        raise AssertionError("K7 would copy LocalMHA's strided q, k, v")
    return views


def keyless_mask(b, t, w):
    """Whole key tiles masked and rows without a key: keys 0-69 of row 0
    (window 0's queries 0-69 have none) and keys 64-191 of the other rows
    (at w 64, window 2's queries have none)."""
    mask = torch.ones(b, t, dtype=torch.bool, device=DEV)
    mask[0, :70] = False
    mask[1:, 64:192] = False
    return mask


def check_keyless_rows(q, k, v, w, mask, label):
    """K7's rows without an allowed key: the model path's mean of the
    window's 2w value slots (zeros for window -1 and padding)."""
    out = la.local_attention(q, k, v, window_size=w, mask=mask, scale=8.0 / 64)
    b, h, t, d = q.shape
    pos = torch.arange(t, device=DEV)
    win = pos // w
    # a query has a key if a valid key lies at or before it, in its window or the one before
    kp = torch.arange(t, device=DEV)
    allowed = (kp[None, :] <= pos[:, None]) & (kp[None, :] >= (win[:, None] - 1) * w)
    keyless = ~(allowed[None] & mask[:, None, :]).any(-1)  # (b, t)
    vw = torch.nn.functional.pad(v.float(), (0, 0, 0, (-t) % w)).reshape(b, h, -1, w, d).sum(3)
    prev = torch.nn.functional.pad(vw, (0, 0, 1, 0))[:, :, :-1]
    mean = ((vw + prev) / (2 * w))[:, :, win]  # (b, h, t, d)
    rows = keyless[:, None, :, None].expand_as(out)
    err = (out.float() - mean)[rows].abs().max().item()
    if int(keyless.sum()) == 0 or err > TOL[q.dtype]:
        raise AssertionError(f"K7 [{label}]: {int(keyless.sum())} keyless rows, max err {err}")
    print(f"local [{label}]: {int(keyless.sum())} rows without a key take the mean of their "
          f"2w value slots (max abs err {err:.3e})")


def local_pairs(b, h, t, w, mask):
    """The (query, key) pairs local attention attends: keys at or before the
    query, in its window or the one before, not masked."""
    pos = torch.arange(t, device=DEV)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] >= (pos[:, None] // w - 1) * w)
    if mask is None:
        return int(band.sum()) * b * h
    return int((band[None] & mask[:, None, :]).sum()) * h


def sdpa_blocks(q, k, v, w, mask, bias):
    """(B*H*nw, 1, w, D) query blocks, (B*H*nw, 1, 2w, D) key and value
    blocks (the window before and the window) and the float mask with the
    band, the first window's look-back, the key mask and the bias, for one
    SDPA call that computes the same function. Yardstick only."""
    b, h, t, d = q.shape
    pad = (-t) % w
    nw = (t + pad) // w
    qp, kp, vp = (torch.nn.functional.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
    kw, vw = (a.reshape(b, h, nw, w, d) for a in (kp, vp))
    k2, v2 = (torch.cat([torch.nn.functional.pad(a, (0, 0, 0, 0, 1, 0))[:, :, :-1], a], 3)
              for a in (kw, vw))
    valid = torch.ones(b, t, dtype=torch.bool, device=DEV) if mask is None else mask
    mw = torch.nn.functional.pad(valid, (0, pad), value=False).reshape(b, nw, w)
    key_valid = torch.cat([torch.nn.functional.pad(mw, (0, 0, 1, 0), value=False)[:, :-1], mw], 2)
    qpos = torch.arange(w, device=DEV)[:, None]
    kpos = torch.arange(2 * w, device=DEV)[None, :]
    allowed = (kpos <= qpos + w)[None, None, None] & key_valid[:, None, :, None, :]
    fmask = torch.zeros(b, h, nw, w, 2 * w, device=DEV)
    if bias is not None:
        fmask = fmask + bias[None, :, None]
    fmask = fmask.masked_fill(~allowed, -1e9).to(q.dtype)
    return (qp.reshape(b * h * nw, 1, w, d), k2.reshape(b * h * nw, 1, 2 * w, d),
            v2.reshape(b * h * nw, 1, 2 * w, d), fmask.reshape(b * h * nw, 1, w, 2 * w))


def check_local(q, k, v, w, mask, bias, label, seed, scale=8.0 / 64):
    """K7 against its plain version (2e-3 fp32, 3e-2 bf16), then the
    backward through its autograd.Function against the plain version's;
    its time, the plain version's, one SDPA call's over pre-built blocks
    (block building not timed) and the bound (the attended pairs' two
    products, or q, k, v, out, the bias and the mask moved once)."""
    kw = dict(window_size=w, mask=mask, attn_bias=bias, scale=scale)
    before = la.launches
    out = la.local_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if la.launches != before + 1:
        raise AssertionError(f"K7 [{label}]: the wrapper did not launch its kernel")
    ref = la.local_attention_ref(q, k, v, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[q.dtype]
    if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
        raise AssertionError(f"K7 vs plain [{label}]: max abs err {err} over {tol}")
    # the backward: the plain version's, recomputed under autograd
    gen = torch.Generator(device=DEV).manual_seed(seed)
    g = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
    diff = [q, k, v] + ([bias] if bias is not None else [])
    leaves = [a.detach().requires_grad_() for a in diff]
    lkw = dict(window_size=w, mask=mask, scale=scale)
    grads = torch.autograd.grad(
        la.local_attention(*leaves[:3], attn_bias=leaves[3] if bias is not None else None, **lkw),
        leaves, g)
    leaves = [a.detach().requires_grad_() for a in diff]
    refs = torch.autograd.grad(
        la.local_attention_ref(*leaves[:3], attn_bias=leaves[3] if bias is not None else None,
                               **lkw), leaves, g)
    gtol = GRAD_TOL[q.dtype]
    grad_err = max((a.float() - r.float()).abs().max().item() for a, r in zip(grads, refs))
    if not all(torch.allclose(a.float(), r.float(), **gtol) for a, r in zip(grads, refs)):
        raise AssertionError(f"K7 backward vs plain [{label}]: max abs err {grad_err} over {gtol}")
    ms = cuda_ms(lambda: la.local_attention(q, k, v, **kw), iters=20)
    dev_ms, dev_launches, _ = device_per_call(lambda: la.local_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: la.local_attention_ref(q, k, v, **kw), iters=20)
    qb, kb, vb, fmask = sdpa_blocks(q, k, v, w, mask, bias)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qb, kb, vb, attn_mask=fmask,
                                                                scale=scale)

    library_ms = cuda_ms(library, iters=20)
    library_dev_ms = device_per_call(library)[0]
    b, h, t, d = q.shape
    pairs = local_pairs(b, h, t, w, mask)
    nbytes = 4 * q.numel() * q.element_size() + (bias.numel() * 4 if bias is not None else 0) \
        + (mask.numel() if mask is not None else 0)
    flops = 4 * d * pairs
    t_ops = flops / (TF32X3_FLOPS if q.dtype == torch.float32 else PEAK_FLOPS[q.dtype]) * 1e3
    t_bytes = nbytes / HBM_BPS * 1e3
    bound_ms, bound_by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    bound_fma_ms = max(flops / PEAK_FLOPS[torch.float32] * 1e3, t_bytes)
    print(f"local [{label}]: max_abs_err {err:.3e} (tol {tol}) | backward {grad_err:.3e} | "
          f"kernel {ms:.4f} ms, on the device {dev_ms:.4f} ms in {dev_launches:g} launches per "
          f"call | plain {plain_ms:.4f} ms | sdpa on blocks {library_ms:.4f} ms (device "
          f"{library_dev_ms:.4f}) | bound {bound_ms:.4f} ms ({bound_by}, {pairs} pairs; at the "
          f"FMA rate {bound_fma_ms:.4f} ms)")
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, device_launches=dev_launches,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                library_device_ms=library_dev_ms, at=label)


@phase("kernels (codec)")
def codec_kernel_phase(seed):
    """K6 at the codec's shape (one quantizer of 8 x 2 s: N = 800, D = 512,
    C = 1024) and at N in {1, 7, 1300}, with duplicated codebook rows and an
    all-zero codebook (every score a tie), one device launch a search; K7
    at the codec's shape (8 x 8 x 100 x 64, w 128), at 10 s (8 x 8 x 500 x
    64: 4 windows), a ragged 2 x 8 x 300 x 64 at w 64 with a key mask and an
    (H, w, 2w) bias, on LocalMHA's strided views at the codec's shape, and
    strided with whole key tiles masked and rows without a key (their
    output the mean of the window's value slots), fp32 and bf16; then both
    at the codec training's shapes: K6 at 400 rows, K7 in float32 on
    LocalMHA's strided 8 x 8 x 50 x 64 at w 64."""
    rng = np.random.default_rng(seed + 20)
    n_codec = CODEC_B * CODEC_S * HZ
    main = check_vq(*vq_inputs(rng, n_codec), f"{n_codec}x512 vs 1024x512 (codec)")
    vq_more = {}
    for n in (1, 7, 1300):
        vq_more[f"{n} rows"] = check_vq(*vq_inputs(rng, n, dup=True),
                                        f"{n}x512 vs 1024x512, 4 equal codes",
                                        want_first=torch.tensor([0], dtype=torch.int32))
    zeros = torch.zeros(1024, 512, device=DEV)
    check_vq(vq_inputs(rng, 7)[0], zeros, "7x512 vs zeros (all ties)",
             want_first=torch.zeros(7, dtype=torch.int32))
    local = {}
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        local[name] = check_local(*local_inputs(rng, 8, 8, 100, 64, dtype, 128)[:3], 128, None,
                                  None, f"{name} 8x8x100x64 w128 (codec)", seed)
        local[f"{name} 10 s"] = check_local(*local_inputs(rng, 8, 8, 500, 64, dtype, 128)[:3],
                                            128, None, None, f"{name} 8x8x500x64 w128 (10 s)",
                                            seed)
        q, k, v, mask, bias = local_inputs(rng, 2, 8, 300, 64, dtype, 64, masked=True,
                                           biased=True)
        check_local(q, k, v, 64, mask, bias, f"{name} ragged 2x8x300x64 w64, key mask, bias",
                    seed)
        # LocalMHA's layout: transposed views of one projection, read in place
        check_local(*local_views(rng, 8, 8, 100, 64, dtype), 128, None, None,
                    f"{name} 8x8x100x64 w128, LocalMHA's strided q, k, v", seed)
        q, k, v = local_views(rng, 2, 8, 300, 64, dtype)
        mask = keyless_mask(2, 300, 64)
        bias = torch.from_numpy(0.3 * rng.standard_normal((8, 64, 128), dtype=np.float32)).to(DEV)
        check_local(q, k, v, 64, mask, bias,
                    f"{name} 2x8x300x64 w64, strided, whole key tiles masked, keyless rows",
                    seed)
        check_keyless_rows(q, k, v, 64, mask, f"{name} 2x8x300x64 w64")
    rows = TRAIN_B * TRAIN_SAMPLES // 320  # one quantizer's rows in a codec train step
    vq_training = check_vq(*vq_inputs(rng, rows), f"{rows}x512 vs 1024x512 (codec training)")
    local_training = check_local(
        *local_views(rng, TRAIN_B, 8, rows // TRAIN_B, 64, torch.float32), 64, None, None,
        f"fp32 {TRAIN_B}x8x{rows // TRAIN_B}x64 w64, LocalMHA's strided q, k, v (codec training)",
        seed)
    return {"vq": main, "vq_more": {"1300 rows": vq_more["1300 rows"]}, "local": local["fp32"],
            "local_more": {k: v for k, v in local.items() if k != "fp32"},
            "vq_training": vq_training, "local_training": local_training}


def fill_codebooks(codec, wave, seed):
    """Each quantizer's codebook filled with rows drawn (seeded, with
    replacement) from its residuals on `wave`, as kmeans init draws its
    candidates: a random-weight codec's codebooks are zeros, every search a
    tie at index 0."""
    gen = torch.Generator(device=wave.device).manual_seed(seed)
    with torch.no_grad():
        h = codec.encode_frames(codec.process_input(wave))
        for rvq, chunk in zip(codec.rq.rvqs, h.chunk(codec.rq_groups, dim=-1)):
            residual = chunk.reshape(-1, chunk.shape[-1])
            for layer in rvq.layers:
                rows = torch.randint(0, residual.shape[0], (layer.codebook_size,),
                                     generator=gen, device=wave.device)
                layer.codebook.copy_(residual[rows])
                residual = residual - layer(residual)[0]


def calibrated_codec(seed, rng, **kw):
    codec = AudioLMSoundStream(codebook_size=1024, seed=seed, device=DEV, **kw).eval()
    calib = torch.from_numpy(0.1 * rng.standard_normal((2 * CODEC_B, CODEC_S * SR),
                                                       dtype=np.float32)).to(DEV)
    fill_codebooks(codec, calib, seed)
    return codec


def wave_error(card, cpu, label):
    """max |card - cpu| over the CPU waveform's peak, within WAVE_REL_TOL."""
    rel = ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    if not rel <= WAVE_REL_TOL:
        raise AssertionError(f"{label}: card vs CPU waveform {rel:.3e} of the peak > "
                             f"{WAVE_REL_TOL}")
    return rel


def compare_codes(cpu_codec, card_h, cpu_h, card_codes, cpu_codes):
    """Card codes against the CPU port's: a frame may differ only where its
    first differing quantizer is a near tie, one the deviation of the two
    encoders' output explains: the CPU's float64 scores of the two codes
    differ by at most 4 |h_card - h_cpu| |e_a - e_b| (a residual moved by
    delta moves a score gap by at most 2 delta |e_a - e_b|); and at most 1%
    of the frames. Returns (frames differing, largest gap)."""
    residuals = []
    with torch.no_grad():
        r = cpu_h
        for layer in cpu_codec.rq.rvqs[0].layers:
            residuals.append(r)
            r = r - layer(r)[0]
    card_codes, cpu_codes = card_codes[0], cpu_codes[0]  # one group: (B, N, Q)
    frames = (card_codes != cpu_codes).any(-1).nonzero().tolist()
    delta = (card_h - cpu_h).norm(dim=-1)
    gaps = []
    for b, n in frames:
        q = int((card_codes[b, n] != cpu_codes[b, n]).nonzero()[0])
        cb = cpu_codec.rq.rvqs[0].layers[q].codebook.double()
        x = residuals[q][b, n].double()
        a, c = int(card_codes[b, n, q]), int(cpu_codes[b, n, q])
        gap = ((cb[a].square().sum() - 2 * x @ cb[a]) - (cb[c].square().sum() - 2 * x @ cb[c]))
        limit = 4 * delta[b, n].double() * (cb[a] - cb[c]).norm()
        print(f"  frame ({b}, {n}): first differs at quantizer {q}, codes {a} vs {c}, score "
              f"gap {gap.item():.3e} (explained up to {limit.item():.3e})")
        if abs(gap.item()) > limit.item():
            raise AssertionError(f"card vs CPU codes at frame ({b}, {n}) quantizer {q}: not a "
                                 f"near tie")
        gaps.append(abs(gap.item()))
    total = cpu_codes.shape[0] * cpu_codes.shape[1]
    if len(frames) > 0.01 * total:
        raise AssertionError(f"card vs CPU codes: {len(frames)} of {total} frames differ (> 1%)")
    return len(frames), max(gaps, default=0.0)


@phase("codec")
def codec_phase(seed):
    """The codec at bench.py's width: codebooks filled from a calibration
    batch, then the tokenize -> decode_from_codebook_indices round trip on
    8 x 2 s (launches zeroed just before one round trip and read just
    after), timed; then the card against the CPU port on a 1-s clip."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"codec: cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    rng = np.random.default_rng(seed + 21)
    codec = calibrated_codec(seed, rng)
    x = torch.from_numpy(0.1 * rng.standard_normal((CODEC_B, CODEC_S * SR),
                                                   dtype=np.float32)).to(DEV)
    with torch.no_grad():
        zero_counts()
        codes = codec.tokenize(x)
        y = codec.decode_from_codebook_indices(codes)
        torch.cuda.synchronize()
        launched = counts()
        want = {name: 0 for name in COUNTERS}
        want.update(launches_vq=12, launches_local=2)
        if launched != want:
            raise AssertionError(f"codec round trip launches {launched} != {want}")
        frames = CODEC_S * HZ
        if codes.shape != (1, CODEC_B, frames, 12) or y.shape != x.shape \
                or not torch.isfinite(y).all():
            raise AssertionError(f"codec round trip: codes {tuple(codes.shape)}, wave "
                                 f"{tuple(y.shape)}, finite {bool(torch.isfinite(y).all())}")
        distinct = codes[0, :, :, 0].unique().numel()
        if distinct < 100:
            raise AssertionError(f"codec: quantizer 0 uses {distinct} codes (< 100)")
        torch.cuda.reset_peak_memory_stats()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            codec.decode_from_codebook_indices(codec.tokenize(x))
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) / iters * 1e3
        peak = torch.cuda.max_memory_allocated()
    audio_s = CODEC_B * CODEC_S
    print(f"codec round trip {CODEC_B}x{CODEC_S}s: {call_ms:.2f} ms per call "
          f"({audio_s / call_ms * 1e3:.1f} s of audio per s) | max_memory_allocated "
          f"{peak / 2**30:.3f} GiB | quantizer 0 uses {distinct} of 1024 codes | launches "
          f"{launched}")
    with torch.no_grad():
        profile(f"codec round trip ({CODEC_B}x{CODEC_S}s)",
                lambda: codec.decode_from_codebook_indices(codec.tokenize(x)), top=10)
        cpu = copy.deepcopy(codec).cpu()
        clip = x[:1, :SR]
        card_h, cpu_h = codec.encode_frames(clip).cpu(), cpu.encode_frames(clip.cpu())
        card_codes, cpu_codes = codec.tokenize(clip).cpu(), cpu.tokenize(clip.cpu())
        differ, gap = compare_codes(cpu, card_h, cpu_h, card_codes, cpu_codes)
        ref = cpu.decode_from_codebook_indices(cpu_codes)
        rel = wave_error(codec.decode_from_codebook_indices(cpu_codes.to(DEV)), ref, "codec 1x1s")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        spread = ((cpu.decode_from_codebook_indices(cpu_codes) - ref).abs().max()
                  / ref.abs().max()).item()
        torch.set_num_threads(threads)
    print(f"codec 1x1s card vs CPU: encoder outputs max abs diff "
          f"{(card_h - cpu_h).abs().max().item():.3e}; {differ} of {HZ} frames' codes differ "
          f"(near ties, largest gap {gap:.3e}); waveform from the same codes {rel:.3e} of the "
          f"peak (limit {WAVE_REL_TOL}; CPU 1 vs {threads} threads {spread:.3e})")
    return launched


# the codec's training at the width of the repository's trained codec, the
# config in persist/soundstream_r5_73k.npz's __meta__ (73k steps of
# examples/train_codec_corpus.py): channels 48, codebook 1024 x 512, 8
# quantizers, window 64, 8 heads of 64, the small discriminators, its loss
# weights; the trainer's arguments of examples/train_codec_corpus.py:111-135,
# 199-208 (batch 8 x 1 s, lr 2e-4, warmup 50, the penalty every 4 steps, EMA)
CODEC_TRAIN = dict(channels=48, strides=(2, 4, 5, 8), channel_mults=(2, 4, 8, 16),
                   codebook_size=1024, codebook_dim=512, rq_num_quantizers=8, rq_groups=1,
                   rq_kwargs=dict(threshold_ema_dead_code=0.25), rq_rotation_trick=True,
                   attn_window_size=64, attn_heads=8, attn_dim_head=64, attn_depth=1,
                   multi_scale_discr_kwargs=dict(channels=8, layers=3, groups=(1, 2, 4),
                                                 chan_max=64),
                   complex_stft_discr_kwargs=dict(channels=8), recon_loss_weight=10.0,
                   si_snr_loss_weight=1.0, multi_spectral_recon_loss_weight=1e-5)
GAN = dict(adversarial_loss_weight=1.0, feature_loss_weight=10.0)  # the script's defaults
RECON = dict(adversarial_loss_weight=0.0, feature_loss_weight=0.0)  # the 73k run's phase
TRAIN_B, TRAIN_SAMPLES, CLIPS, CLIP_SAMPLES = 8, SR, 64, 2 * SR
# the EMA's warm copy ends at step 4 and it updates every other step, so the
# timed steps see it move (the script's 500 and 10 would not show in 9 steps)
TRAINER_KW = dict(batch_size=TRAIN_B, data_max_length=TRAIN_SAMPLES, grad_accum_every=1,
                  lr=2e-4, warmup_steps=50, apply_grad_penalty_every=4, use_ema=True,
                  ema_update_after_step=4, ema_update_every=2, num_train_steps=100,
                  save_results_every=10 ** 9, save_model_every=10 ** 9)
TIMED_STEPS = 8
# card vs CPU on one G step and one D step with the penalty, from the same
# weights, batch and draws: each loss term within LOSS_REL of the CPU's; the
# worst gradient leaf by relative norm within LEAF_TOL (as the LMs'), or 4x
# the CPU's own spread where that is larger (card_vs_cpu); the
# quantizers' buffers within STATE_REL of the CPU's largest, on the codes no
# differing frame touched; codes identical but for near ties, at most 1% of
# the frames
LOSS_REL, STATE_REL = 2e-3, 1e-4
CPU_CHECK_B = 4


def write_clips(folder, seed):
    """CLIPS clips of 2 s at 16 kHz in folder: a sine of 100-1000 Hz (and
    its octave) with noise, from `seed`, written by the port's WAV writer."""
    from audiolm_pytorch_tpu_torch.utils.audio_io import save_audio
    rng = np.random.default_rng(seed)
    t_ = np.arange(CLIP_SAMPLES) / SR
    for i in range(CLIPS):
        f = rng.uniform(100, 1000)
        x = 0.4 * np.sin(2 * np.pi * f * t_) + 0.2 * np.sin(4 * np.pi * f * t_ + rng.uniform(0, 6))
        save_audio(folder / f"clip_{i:03d}.wav", x + 0.05 * rng.standard_normal(CLIP_SAMPLES), SR)


def codec_trainer(folder, results, seed, weights, **kw):
    from audiolm_pytorch_tpu_torch import SoundStream, SoundStreamTrainer
    model = SoundStream(**CODEC_TRAIN, **weights, seed=seed, device=DEV)
    return SoundStreamTrainer(model, folder=folder, results_folder=results, seed=seed,
                              device=DEV, **TRAINER_KW, **kw)


class StepProbe:
    """Wraps a trainer's g_step and d_step: CUDA events around each, the
    quantizers' buffers before and after each, and each residual quantizer's
    last kept index (from its dropout draw) in the G step."""

    def __init__(self, trainer):
        self.trainer, self.records = trainer, []
        g_step, d_step = trainer.g_step, trainer.d_step
        self.kept = []
        for rvq in trainer.model.rq.rvqs:
            last_kept = rvq._last_kept

            def record(train, generator, last_kept=last_kept):
                out = last_kept(train, generator)
                if train:
                    self.kept.append(out)
                return out

            rvq._last_kept = record

        def timed(name, fn):
            def run(*args):
                before = self.rq_state()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = fn(*args)
                end.record()
                torch.cuda.synchronize()
                self.records.append(dict(name=name, gp=bool(args[1:] and args[1]),
                                         ms=start.elapsed_time(end), before=before,
                                         after=self.rq_state()))
                return out
            return run

        trainer.g_step, trainer.d_step = timed("g", g_step), timed("d", d_step)

    def rq_state(self):
        return {k: v.clone() for k, v in self.trainer.model.rq.state_dict().items()}


def check_vq_buffers(probe, steps):
    """The G step changes the kept quantizers' buffers, the D step none."""
    for rec in probe.records[-2 * steps:]:
        changed = [k for k in rec["before"] if not torch.equal(rec["before"][k], rec["after"][k])]
        if rec["name"] == "d" and changed:
            raise AssertionError(f"codec training: the D step changed the quantizers: {changed}")
        if rec["name"] == "g" and not any(k.endswith("codebook") for k in changed):
            raise AssertionError("codec training: the G step left every codebook as it was")


def train_launches(trainer, probe, label):
    """One train_step with the launch counts zeroed just before and read
    just after: K6 once a kept quantizer in the G forward (its dropout keeps
    quantizers 0..k) and once a quantizer in the D forward (eval: all 8); K7
    once in the encoder and once in the decoder of each forward; nothing
    else."""
    probe.kept.clear()
    torch.cuda.synchronize()
    zero_counts()
    logs = trainer.train_step()
    torch.cuda.synchronize()
    launched = counts()
    forwards = 1 + trainer.train_discriminators
    want = {name: 0 for name in COUNTERS}
    want.update(launches_vq=sum(k + 1 for k in probe.kept)
                + (trainer.train_discriminators * CODEC_TRAIN["rq_num_quantizers"]),
                launches_local=2 * forwards)
    print(f"codec training [{label}] launches: {launched} (kept quantizers 0..{probe.kept}; "
          f"want K6 {want['launches_vq']}, K7 {want['launches_local']})")
    if launched != want:
        raise AssertionError(f"codec training [{label}] launches {launched} != {want}")
    return logs, launched


def check_loss_terms(logs, label):
    if not all(np.isfinite(v) for v in logs.values()):
        raise AssertionError(f"codec training [{label}]: a loss term is not finite: {logs}")


class CodeProbe:
    """Forward hooks on each quantizer: its input (the residual), its
    codebook as the search saw it and the codes it picked."""

    def __init__(self, model):
        self.calls = []
        self.handles = []
        for q, layer in enumerate(model.rq.rvqs[0].layers):
            self.handles.append(layer.register_forward_pre_hook(
                lambda m, args, q=q: self.calls.append(
                    dict(q=q, x=args[0].detach().cpu(), codebook=m.codebook.detach().cpu()))))
            self.handles.append(layer.register_forward_hook(
                lambda m, args, out: self.calls[-1].update(codes=out[1].cpu())))

    def remove(self):
        for h in self.handles:
            h.remove()


def g_and_d_grads(model, wave, seed, fault=None):
    """One G step's loss terms and gradients (the quantizers train, drawing
    from a generator seeded with `seed`) and one D step's loss and gradients
    with the penalty, on `model` as it is; the quantizers' state after the G
    step; the codes. With fault (the card only), the gradient into the
    encoder's K7 output is zeroed."""
    from audiolm_pytorch_tpu_torch.ops import attention as attn_mod
    named = dict(model.named_parameters())
    gen_names = [n for n in named if not n.startswith(("discriminators", "stft_discriminator"))]
    dis_names = [n for n in named if n not in gen_names]
    probe = CodeProbe(model)
    local_attention = attn_mod.local_attention
    if fault:
        calls = []

        def zeroed(*args, **kw):
            out = local_attention(*args, **kw)
            if not calls:  # the encoder's, the first in the forward
                out.register_hook(torch.zeros_like)
            calls.append(1)
            return out

        attn_mod.local_attention = zeroed
    try:
        total, terms = model(wave, train=True, generator=torch.Generator().manual_seed(seed),
                             return_loss_breakdown=True)
        g = torch.autograd.grad(total, [named[n] for n in gen_names], allow_unused=True)
    finally:
        attn_mod.local_attention = local_attention
        probe.remove()
    grads = {n: (torch.zeros_like(named[n]) if x is None else x).cpu()
             for n, x in zip(gen_names, g)}
    rq = {k: v.cpu().clone() for k, v in model.rq.state_dict().items()}
    d_loss = model(wave, return_discr_loss=True, apply_grad_penalty=True)
    grads.update({n: x.cpu() for n, x in zip(
        dis_names, torch.autograd.grad(d_loss, [named[n] for n in dis_names]))})
    losses = [v.detach().item() for v in terms] + [d_loss.detach().item()]
    return losses, grads, rq, probe.calls


def codes_near_ties(card_calls, cpu_calls):
    """Card codes against the CPU port's, quantizer by quantizer: where they
    differ, the CPU's float64 scores of the two picks must be a near tie
    that the deviation of the two inputs explains (4 |x_card - x_cpu|
    |e_a - e_b|, as compare_codes) or within NEAR_TIE of the terms. Returns
    (frames that differ, the codes they touch per quantizer)."""
    frames, touched = set(), {}
    for card, cpu in zip(card_calls, cpu_calls):
        diff = (card["codes"] != cpu["codes"]).reshape(-1).nonzero().flatten()
        x, xc = cpu["x"].reshape(-1, cpu["x"].shape[-1]), card["x"].reshape(-1, cpu["x"].shape[-1])
        cb = cpu["codebook"].double()
        for r in diff.tolist():
            a = int(card["codes"].reshape(-1)[r])
            b = int(cpu["codes"].reshape(-1)[r])
            xd = x[r].double()
            gap = abs(((cb[a].square().sum() - 2 * xd @ cb[a])
                       - (cb[b].square().sum() - 2 * xd @ cb[b])).item())
            terms = (cb[a].square().sum() + 2 * xd.norm() * cb[a].norm()).item()
            limit = max(4 * (xc[r] - x[r]).double().norm().item() * (cb[a] - cb[b]).norm().item(),
                        NEAR_TIE * terms)
            if gap > limit:
                raise AssertionError(f"codec training card vs CPU: quantizer {card['q']} row {r} "
                                     f"codes {a} vs {b}, score gap {gap:.3e} > {limit:.3e}")
            frames.add(r)
            touched.setdefault(card["q"], set()).update((a, b))
    return frames, touched


def leaf_gaps(got, ref):
    """{leaf: relative-norm gap} over the leaves whose reference norm is
    over 1e-6 of the largest."""
    largest = max(v.norm().item() for v in ref.values())
    return {n: ((got[n] - v).norm() / v.norm()).item() for n, v in ref.items()
            if v.norm().item() > 1e-6 * largest}


def worst_leaf(got, ref, limits):
    """(gap, limit, leaf) of the leaf furthest over its limit."""
    gaps = leaf_gaps(got, ref)
    name = max(gaps, key=lambda n: gaps[n] / limits[n])
    return gaps[name], limits[name], name


def card_vs_cpu(trainer, wave, seed):
    """The card against the CPU port from the trainer's model as it is (its
    codebooks initialised), on the same batch and draws; then the same check
    must reject the card's gradients with the encoder's K7 output gradient
    zeroed."""
    from audiolm_pytorch_tpu_torch import SoundStream
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    cpu = SoundStream(**CODEC_TRAIN, **GAN, device="cpu")
    cpu.load_state_dict(state)
    card = trainer.model
    c_losses, c_grads, c_rq, c_calls = g_and_d_grads(cpu, wave.cpu(), seed)
    # the CPU's own spread: the same pass with one thread (another summation
    # order). A leaf whose gradient cancels to float32 noise (the decoder's
    # last bias under the SI-SNR loss, which ignores an offset) cannot be
    # held to LEAF_TOL; it is held to 4x its spread
    cpu.load_state_dict(state)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spread = leaf_gaps(g_and_d_grads(cpu, wave.cpu(), seed)[1], c_grads)
    finally:
        torch.set_num_threads(threads)
    limits = {n: max(LEAF_TOL, 4 * x) for n, x in spread.items()}
    noisy = {n: x for n, x in spread.items() if limits[n] > LEAF_TOL}
    g_losses, g_grads, g_rq, g_calls = g_and_d_grads(card, wave, seed)
    names = ("recon", "mel", "stft", "si_snr", "adversarial", "feature", "commit", "discr")
    for name, a, b in zip(names, g_losses, c_losses):
        if not np.isfinite(a) or abs(a - b) > LOSS_REL * max(abs(b), 1e-6):
            raise AssertionError(f"codec training card vs CPU: {name} loss {a} vs {b}")
    gap, limit, leaf = worst_leaf(g_grads, c_grads, limits)
    if gap > limit:
        raise AssertionError(f"codec training card vs CPU: gradient leaf {leaf} {gap:.3e} > "
                             f"{limit:.3e}")
    frames, touched = codes_near_ties(g_calls, c_calls)
    n_frames = wave.shape[0] * wave.shape[1] // 320
    if len(frames) > 0.01 * n_frames:
        raise AssertionError(f"codec training card vs CPU: {len(frames)} of {n_frames} frames "
                             f"differ (> 1%)")
    state_gap = 0.0
    for k, ref in c_rq.items():
        if not ref.is_floating_point():
            if not torch.equal(g_rq[k], ref):
                raise AssertionError(f"codec training card vs CPU: {k} differs")
            continue
        q = int(k.split(".")[3])
        keep = torch.ones(ref.shape[0], dtype=torch.bool)
        keep[list(touched.get(q, ()))] = False
        rel = ((g_rq[k][keep] - ref[keep]).abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        state_gap = max(state_gap, rel)
    if state_gap > STATE_REL:
        raise AssertionError(f"codec training card vs CPU: quantizer state {state_gap:.3e}")
    card.load_state_dict(state)
    _, f_grads, _, _ = g_and_d_grads(card, wave, seed, fault=True)
    fault_gap, fault_limit, fault_leaf = worst_leaf(f_grads, c_grads, limits)
    if fault_gap <= fault_limit:
        raise AssertionError(f"codec training: the gradient check let the card through with the "
                             f"encoder's K7 output gradient zeroed ({fault_gap:.3e})")
    card.load_state_dict(state)
    print(f"codec training card vs CPU ({wave.shape[0]}x{wave.shape[1] / SR:g}s, one G step and "
          f"one D step with the penalty): losses "
          + " ".join(f"{n} {a:.5g}/{b:.5g}" for n, a, b in zip(names, g_losses, c_losses))
          + f" | worst gradient leaf {gap:.3e} ({leaf}; limit {limit:.3e}; leaves held to 4x "
          f"the CPU's own spread: {', '.join(f'{n} {x:.2e}' for n, x in noisy.items())})"
          f" | quantizer state "
          f"{state_gap:.3e} where the codes agree (limit {STATE_REL}) | {len(frames)} of "
          f"{n_frames} frames' codes differ (near ties) | the encoder's K7 output gradient "
          f"zeroed: {fault_gap:.3e} ({fault_leaf}), rejected")
    return dict(worst_leaf=gap, worst_leaf_limit=limit, noisy_leaves=noisy,
                state_gap=state_gap, frames_differ=len(frames), fault_gap=fault_gap)


def k7_backward_ms(rng):
    """K7's backward at the training shape (LocalMHA's strided views of
    8 x 8 x 50 x 64, window 64): the plain version recomputed under
    autograd, timed as forward + backward less the forward."""
    q, k, v = local_views(rng, TRAIN_B, 8, TRAIN_SAMPLES // 320, 64, torch.float32)
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    g = torch.randn_like(q)
    kw = dict(window_size=64, scale=8.0 / 64)
    both = cuda_ms(lambda: torch.autograd.grad(la.local_attention(*leaves, **kw), leaves, g),
                   iters=20)
    with torch.no_grad():
        fwd = cuda_ms(lambda: la.local_attention(*leaves, **kw), iters=20)
    return both - fwd


@phase("codec training")
def codec_training_phase(seed):
    """SoundStreamTrainer.train_step on the card at the trained codec's
    width, on 64 clips of 2 s written from `seed` (random weights from
    `seed`; 1-s crops, batch 8): (a) the GAN, one warm step then 8 timed
    (the penalty at steps 0, 4 and 8), each G and D step by CUDA events and
    the step by the host clock, one step profiled; (b) reconstruction only,
    3 steps, the discriminators untouched. Gates: finite loss terms, launch
    counts per step, the quantizers' buffers moved by the G step and not by
    the D step, the EMA apart from the model after its warm copy, the card
    against the CPU port (and the check shown to reject a fault), and a
    saved and loaded trainer's next loss bit-equal to the uninterrupted
    trainer's. K6 and K7 at the training shapes: the codec kernels phase."""
    import tempfile
    from pathlib import Path
    build = Path(__file__).resolve().parent / "build"  # git-ignored, in the checkout
    build.mkdir(exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k7_bwd_ms = k7_backward_ms(np.random.default_rng(seed + 30))
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        write_clips(tmp / "clips", seed)
        # (a) the GAN
        trainer = codec_trainer(tmp / "clips", tmp / "gan", seed, GAN)
        try:
            probe = StepProbe(trainer)
            t0 = time.perf_counter()
            check_loss_terms(trainer.train_step(), "gan, warm step")  # kmeans init, penalty
            warm_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            step_ms = []
            for _ in range(TIMED_STEPS):
                t0 = time.perf_counter()
                logs = trainer.train_step()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                check_loss_terms(logs, f"gan, step {trainer.steps - 1}")
            peak = torch.cuda.max_memory_allocated()
            check_vq_buffers(probe, TIMED_STEPS)
            recs = probe.records[2:]
            g_ms = [r["ms"] for r in recs if r["name"] == "g"]
            d_ms = [r["ms"] for r in recs if r["name"] == "d" and not r["gp"]]
            dgp_ms = [r["ms"] for r in recs if r["name"] == "d" and r["gp"]]
            if len(dgp_ms) != 2:
                raise AssertionError(f"codec training: {len(dgp_ms)} timed steps had the penalty")
            audio_s = TRAIN_B * TRAIN_SAMPLES / SR
            mean_step = float(np.mean(step_ms))
            print(f"codec training [gan] {TRAIN_B}x{TRAIN_SAMPLES / SR:g}s: warm step "
                  f"{warm_s:.2f} s | {TIMED_STEPS} steps {mean_step:.2f} ms each by the host "
                  f"clock ({min(step_ms):.2f}-{max(step_ms):.2f}) | G step {np.mean(g_ms):.2f} "
                  f"ms, D step {np.mean(d_ms):.2f} ms, D step with the penalty "
                  f"{np.mean(dgp_ms):.2f} ms (CUDA events) | {audio_s / mean_step * 1e3:.1f} s "
                  f"of audio trained per s | max_memory_allocated {peak / 2**30:.3f} GiB | "
                  f"last losses {logs}")
            shadow = dict(trainer.ema.shadow.named_parameters())
            moved = sum(not torch.equal(p, shadow[n]) for n, p in trainer.model.named_parameters())
            if trainer.ema.step <= TRAINER_KW["ema_update_after_step"] or not moved:
                raise AssertionError(f"codec training: the EMA shadow equals the model after "
                                     f"{trainer.ema.step} updates")
            logs, launched = train_launches(trainer, probe, "gan")
            check_loss_terms(logs, "gan, counted step")
            busy, wall, prof_rows = profile("codec training [gan] (one step)", trainer.train_step,
                                            top=12)
            share = {name: sum(ms for ms, _, key in prof_rows if pat in key) / busy
                     for name, pat in (("K6", "vq_nearest_kernel"),
                                       ("K7", "local_attn_kernel"))}
            recompute = 2 * k7_bwd_ms / np.mean(g_ms)
            print(f"codec training [gan] shares of the device's busy time: K6 "
                  f"{100 * share['K6']:.2f}%, K7 forward {100 * share['K7']:.2f}%; K7's "
                  f"backward (the plain version recomputed, {k7_bwd_ms:.4f} ms a call, 2 a G "
                  f"step) {100 * recompute:.2f}% of the G step; "
                  f"{100 * (1 - busy / wall):.1f}% idle")
            # the first second of the first clips (the loader's crops are drawn
            # by its threads in no fixed order)
            from audiolm_pytorch_tpu_torch.utils.audio_io import load_audio
            wave = torch.from_numpy(np.stack([
                load_audio(f)[0][0, :TRAIN_SAMPLES]
                for f in sorted((tmp / "clips").glob("*.wav"))[:CPU_CHECK_B]])).to(DEV)
            cpu_check = card_vs_cpu(trainer, wave, seed)
            # saved and loaded: the next step's loss bit-equal
            batch = torch.from_numpy(trainer._stack_accum(trainer.dl_iter)).to(DEV)
            trainer.save(tmp / "gan" / "soundstream.resume.ckpt.npz")
            resumed = codec_trainer(tmp / "clips", tmp / "resumed", seed, GAN)
            try:
                resumed.load(tmp / "gan" / "soundstream.resume.ckpt.npz")
                ours, theirs = trainer.g_step(batch)[0], resumed.g_step(batch)[0]
                if not torch.equal(ours, theirs):
                    raise AssertionError(f"codec training: the resumed trainer's loss {theirs} "
                                         f"is not the uninterrupted trainer's {ours}")
            finally:
                resumed.close()
            print(f"codec training: saved and loaded into a fresh trainer, the next G loss "
                  f"{float(ours)!r} bit-equal to the uninterrupted trainer's")
        finally:
            trainer.close()
        del trainer, resumed
        torch.cuda.empty_cache()
        # (b) reconstruction only: the discriminators neither run nor move
        trainer = codec_trainer(tmp / "clips", tmp / "recon", seed, RECON,
                                train_discriminators=False)
        try:
            probe = StepProbe(trainer)
            discr = {n: p.clone() for n, p in trainer.model.named_parameters()
                     if n.startswith(("discriminators", "stft_discriminator"))}
            check_loss_terms(trainer.train_step(), "recon")
            recon_logs, recon_launched = train_launches(trainer, probe, "recon")
            check_loss_terms(recon_logs, "recon")
            check_loss_terms(trainer.train_step(), "recon")
            moved = [n for n, p in trainer.model.named_parameters()
                     if n in discr and not torch.equal(p, discr[n])]
            if moved or recon_logs["adversarial"] or recon_logs["feature_loss"]:
                raise AssertionError(f"codec training [recon]: the discriminators moved {moved} "
                                     f"or ran ({recon_logs})")
            print(f"codec training [recon] 3 steps: losses {recon_logs} | the discriminators' "
                  f"{len(discr)} parameters bit-equal before and after")
        finally:
            trainer.close()
    return launched, dict(step_ms=mean_step, g_ms=float(np.mean(g_ms)),
                          d_ms=float(np.mean(d_ms)), d_penalty_ms=float(np.mean(dgp_ms)),
                          peak_bytes=peak, k7_backward_recompute_ms=k7_bwd_ms,
                          k6_share=share["K6"], k7_share=share["K7"], idle=1 - busy / wall,
                          recon_launches=recon_launched, **cpu_check)


@phase("audiolm")
def audiolm_phase(seed):
    """AudioLM on the card at _build_gen's widths (bench.py:316): the codec
    with 8 quantizers (codebooks filled as in the codec phase), the Semantic
    LM at the flagship width and the Coarse and Fine LMs at bench.py's,
    random weights from `seed`, float32, greedy, batch 1: 50 semantic ids ->
    150 coarse -> 250 fine codes -> 1 s of audio. One warm run, then one run
    with the launch counts zeroed just before and read just after; the card's
    decode of the generated grid (the three wrappers in turn with the same
    generator) against the CPU port's."""
    rng = np.random.default_rng(seed + 22)
    codec = calibrated_codec(seed, rng, rq_num_quantizers=8)
    semantic = SemanticTransformer(**FLAGSHIP, seed=seed, device=DEV).eval()
    coarse = CoarseTransformer(**COARSE, seed=seed, device=DEV).eval()
    fine = FineTransformer(**FINE, seed=seed, device=DEV).eval()
    audiolm = AudioLM(codec=codec, semantic_transformer=semantic, coarse_transformer=coarse,
                      fine_transformer=fine)
    kw = dict(batch_size=1, max_length=HZ, max_coarse_time_steps=HZ, temperature=1e-10)
    audiolm(**kw, generator=torch.Generator(device=DEV).manual_seed(seed))  # warm
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    wave = audiolm(**kw, generator=torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = counts()
    if isinstance(wave, list) or wave.shape != (1, SR) or not torch.isfinite(wave).all():
        shape = [None if w is None else tuple(w.shape) for w in wave] \
            if isinstance(wave, list) else tuple(wave.shape)
        raise AssertionError(f"audiolm: waveform {shape}, want (1, {SR}) and finite")
    gen = torch.Generator(device=DEV).manual_seed(seed)
    sem = audiolm.semantic.generate(batch_size=1, max_length=HZ, temperature=1e-10, generator=gen)
    co = audiolm.coarse.generate(semantic_token_ids=sem, max_time_steps=HZ, temperature=1e-10,
                                 generator=gen)
    fi = audiolm.fine.generate(coarse_token_ids=co, temperature=1e-10, generator=gen)
    grid = torch.cat([co, fi], -1)
    with torch.no_grad():
        card = decode_acoustic_tokens(codec, grid)
        if not torch.equal(card, wave):
            raise AssertionError("audiolm: the chain's waveform is not the decode of its "
                                 "wrappers' grid")
        rel = wave_error(card, copy.deepcopy(codec).cpu().decode_from_codebook_indices(
            grid.cpu()), "audiolm 1 s")
    print(f"audiolm b1 {HZ} semantic ids -> {co.shape[1] * co.shape[2]} coarse -> "
          f"{fi.shape[1] * fi.shape[2]} fine codes -> {wave.shape[-1]} samples: {wall_s:.2f} s "
          f"wall ({wave.shape[-1] / SR / wall_s:.3f} s of audio per s) | card vs CPU decode of "
          f"the grid {rel:.3e} of the peak | launches K1 {launched['launches']}, K6 "
          f"{launched['launches_vq']}, K7 {launched['launches_local']}")
    return launched


# the outputs of each row's kernel in the tf32 phase's float64 check
F64_OUTPUTS = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv"), "dbias": ("dbias",)}
# the TPU kernel each port replaces, by line in the JAX package
KERNELS = [
    ("fwd", "flash_fwd", fa.SOURCE, "ops/pallas/flash_attention.py:34", "launches"),
    ("dq", "flash_bwd_dq", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:179", "launches_dq"),
    ("dkv", "flash_bwd_dkv", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:233",
     "launches_dkv"),
    # K4 and K5 are fused into K2's launch; their rows carry that launch's numbers
    ("dtab", "flash_bwd_dq:dtab", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:344",
     "launches_dtab"),
    ("dbias", "flash_bwd_dq:dbias", fa.SOURCE_BWD, "ops/pallas/flash_attention.py:293",
     "launches_dbias"),
    ("vq", "vq_nearest", vq.SOURCE, "ops/pallas/vq.py:21", "launches_vq"),
    ("local", "local_attn_fwd", la.SOURCE, "ops/pallas/local_attention.py:26", "launches_local"),
]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    t0 = time.perf_counter()
    smi = device_phase()
    build_phase()
    timings = kernel_phase(args.seed)
    timings["sass"] = sass_phase()
    timings["tf32"] = accuracy_phase(args.seed)
    timings.update(codec_kernel_phase(args.seed))
    cpu_model = flagship(args.seed)
    model = copy.deepcopy(cpu_model).to(DEV)
    paths = {"scoring": scoring_phase(args.seed, model, cpu_model),
             "generation": generation_phase(args.seed, model)}
    paths["training"] = training_phase(args.seed, cpu_model)
    del model, cpu_model
    coarse_grid = None
    for kind in ("coarse", "fine"):
        cpu_lm = acoustic_model(kind, args.seed)
        lm = copy.deepcopy(cpu_lm).to(DEV)
        paths[f"{kind}_scoring"] = phase(f"{kind} scoring")(acoustic_scoring)(
            kind, args.seed, lm, cpu_lm)
        if kind == "coarse":
            paths["coarse_generation"], coarse_grid = phase("coarse generation")(
                coarse_generation)(args.seed, lm)
        else:
            paths["fine_generation"] = phase("fine generation")(fine_generation)(
                args.seed, lm, coarse_grid)
        paths[f"{kind}_training"] = phase(f"{kind} training")(acoustic_training)(
            kind, args.seed, cpu_lm)
        del lm, cpu_lm
        torch.cuda.empty_cache()
    paths["codec"] = codec_phase(args.seed)
    paths["codec_training"], timings["codec_training"] = codec_training_phase(args.seed)
    paths["audiolm"] = audiolm_phase(args.seed)
    rows = []
    for key, name, source, replaces, counter in KERNELS:
        per_path = {f"launches_{p}": launched[counter] for p, launched in paths.items()}
        if sum(per_path.values()) == 0:
            raise AssertionError(f"the main path launched no {name} kernel")
        # K1-K3 also carry their (H, N, N)-bias form's numbers at the Fine training
        # shape (and the Coarse shape's); every flash row its bf16 numbers
        numbers = timings["bias"][key] if key == "dbias" else dict(timings[key])
        if key in ("fwd", "dq", "dkv"):
            numbers["bias_form"] = timings["bias"][key]
            numbers["bias_form_coarse"] = timings["coarse"]["fp32"][key]
        if key in ("fwd", "dq", "dkv", "dtab", "dbias"):
            bf16 = timings["bf16"]
            numbers["bf16"] = bf16["bias"][key] if key == "dbias" else bf16[key]
            if key in ("fwd", "dq", "dkv"):
                numbers["bf16"] = dict(numbers["bf16"], bias_form=bf16["bias"][key],
                                       bias_form_coarse=timings["coarse"]["bf16"][key])
        if key in ("fwd", "dq", "dkv", "vq", "local"):
            numbers["hmma"] = timings["sass"][key]
        if key in ("vq", "local"):
            # K6 at 1300 rows; K7 in bf16 and at 10 s, with the float64 check;
            # both at the codec training's shapes
            numbers.update(more=timings[f"{key}_more"], tf32=timings["tf32"][key],
                           training_shape=timings[f"{key}_training"])
        if key in ("fwd", "dq", "dkv", "dbias"):
            outputs = F64_OUTPUTS[key]
            numbers["f64_rel_err"] = {label: {kind: {x: e for x, e in errs.items() if x in outputs}
                                              for kind, errs in timings["tf32"][label].items()}
                                      for label in ("table", "bias")}
        rows.append(dict(name=name, route="cuda", source=f"audiolm_pytorch_tpu_torch/csrc/{source}",
                         replaces=replaces,  # in the JAX package
                         launches=sum(per_path.values()), **per_path, **numbers))
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
