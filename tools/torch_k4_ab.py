"""Checks and times K4, the rel-pos table's gradient of the flash backward
(K2's `dtab`), for two checkouts of the port on one card, each run in a
process of its own, in turns (A, B, B, A):

- repeats, `--runs` times, the comparison of
  `tests/test_torch_cuda.py::test_integer_tf32_rounding_gives_the_conversions_bits[table]`
  (the backward of 8 heads, 1 kv head, B = 4, N = 300, causal, a key mask,
  in float32, built with the integer tf32 rounding and with `cvt.rna`), and
  prints every run whose dtab differs: the elements that differ, the
  largest difference, where it lies, the two values there and the largest
  |dtab|, whether the test's former tolerance (rtol 1e-5, atol 1e-6) held,
  and the element furthest outside it, with its two values;
- counts the distinct bit patterns of dtab over `--runs` calls of K2 on
  the same inputs;
- times K2 with K4 (`bwd_dq` with the table) and K2 alone (`bwd_dq`
  without a bias) at the Semantic LM's training shape, 4 x 8 x 2049 x 64,
  one kv head, causal, 15% of the keys forgotten, in float32 and bf16, by
  CUDA events (tools/cuda_timing.py, the timer chip_smoke.py uses).

    python tools/torch_k4_ab.py --a PATH --b PATH [--runs N] [--seed N]
    python tools/torch_k4_ab.py --tree PATH [--runs N] [--seed N]   # one run, one JSON line

A checkout is a directory that holds `audiolm_pytorch_tpu_torch/` (for
example `git archive <commit> audiolm_pytorch_tpu_torch` unpacked into a
git-ignored directory). Needs a CUDA card; imports torch, numpy, the
standard library, tools/cuda_timing.py and the checkout's port.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.cuda_timing import cuda_ms  # noqa: E402


def test_inputs(dev):
    """The inputs of the GPU test (its `_k2_inputs(8, 1, 4, 300, 300, True,
    "table")`, seed 30)."""
    rng = np.random.default_rng(30)
    h, hk, b, n = 8, 1, 4, 300
    q, k, v, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
                  for s in [(b, h, n, 64), (b, hk, n, 64), (b, hk, n, 64), (b, h, n, 64)])
    tab = torch.from_numpy((0.5 * rng.normal(size=(2 * n - 1, h))).astype(np.float32)).to(dev)
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[-1, (2 * n) // 3:] = False
    mask[0, 3:7] = False
    return q, k, v, g, tab, mask.to(dev)


def dtab_of(fa, q, k, v, g, tab, mask):
    out, lse = fa.flash_attention(q, k, v, bias_tab=tab, key_mask=mask, causal=True,
                                  return_lse=True)
    return fa.flash_attention_bwd(q, k, v, tab, mask, out, lse, g, causal=True, scale=0.125)[3]


def run_tree(path: str, runs: int, seed: int) -> dict:
    sys.path.insert(0, path)
    from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"tree": path, "fail_old_tolerance": 0, "not_bit_equal": 0, "differing_runs": []}
    q, k, v, g, tab, mask = test_inputs(dev)
    for i in range(runs):
        ours = dtab_of(fa, q, k, v, g, tab, mask)
        with fa.built_with(("MMA_TF32_CVT",)):
            theirs = dtab_of(fa, q, k, v, g, tab, mask)
        if torch.equal(ours, theirs):
            continue
        diff = (ours - theirs).abs()
        at = divmod(int(diff.argmax()), ours.shape[1])
        # the element furthest outside the former tolerance (rtol 1e-5, atol 1e-6)
        excess = diff - (1e-6 + 1e-5 * theirs.abs())
        worst = divmod(int(excess.argmax()), ours.shape[1])
        close = bool(excess.max() <= 0)
        out["not_bit_equal"] += 1
        out["fail_old_tolerance"] += not close
        out["differing_runs"].append(dict(
            run=i, elements=int((diff > 0).sum()), max_abs_diff=diff.max().item(),
            at_delta_head=at, ours=ours[at].item(), cvt=theirs[at].item(),
            max_abs_dtab=theirs.abs().max().item(), within_old_tolerance=close,
            worst_delta_head=worst, worst_ours=ours[worst].item(),
            worst_cvt=theirs[worst].item()))
    out["runs"] = runs
    # K2's dtab on the same inputs, run after run
    ref = dtab_of(fa, q, k, v, g, tab, mask)
    out["distinct_dtab_bits"] = 1 + sum(
        not torch.equal(dtab_of(fa, q, k, v, g, tab, mask), ref) for _ in range(runs - 1))

    rng = np.random.default_rng(seed)
    b, h, n, d = 4, 8, 2049, 64
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        q, g = (torch.from_numpy(rng.standard_normal((b, h, n, d), dtype=np.float32))
                .to(dev, dtype) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal((b, 1, n, d), dtype=np.float32))
                .to(dev, dtype) for _ in range(2))
        tab = torch.from_numpy(0.5 * rng.standard_normal((2 * n - 1, h), dtype=np.float32)).to(dev)
        mask = torch.from_numpy(rng.random((b, n)) >= 0.15).to(dev)
        mask[:, 0] = True
        o, lse = fa.flash_attention(q, k, v, bias_tab=tab, key_mask=mask, causal=True,
                                    return_lse=True)
        args = (q, k, v, g, lse, (g.float() * o.float()).sum(-1), tab,
                mask.to(torch.int8).contiguous())
        no_tab = args[:6] + (None,) + args[7:]
        kw = dict(causal=True, scale=d ** -0.5)
        out[name] = {"k2_k4_ms": cuda_ms(lambda: fa.bwd_dq(*args, **kw), iters=20),
                     "k2_alone_ms": cuda_ms(lambda: fa.bwd_dq(*no_tab, **kw), iters=20)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a")
    ap.add_argument("--b")
    ap.add_argument("--tree")
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.tree:
        print(json.dumps(run_tree(args.tree, args.runs, args.seed)))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    print(smi)
    for tree in (args.a, args.b, args.b, args.a):
        res = subprocess.run([sys.executable, __file__, "--tree", tree, "--runs", str(args.runs),
                              "--seed", str(args.seed)], capture_output=True, text=True,
                             timeout=1200)
        if res.returncode != 0:
            print(res.stdout, res.stderr)
            raise SystemExit(f"{tree}: exit {res.returncode}")
        print(res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
