"""Times the flash kernels' float32 builds against each other on one card:
the default build, whose tf32 rounding (`tc::to_tf32` in `csrc/mma.cuh`) is
done by integer ops, and the build with -DMMA_TF32_CVT, which takes the
conversion instruction cvt.rna.tf32.f32. The two give the same bits
(`tests/test_torch_cuda.py::test_integer_tf32_rounding_gives_the_conversions_bits`);
this prints what the rounding costs K1, K2 (alone, and with the bias's
gradient in its launch) and K3 at the training shapes of the three LMs,
the builds interleaved (default, cvt, cvt, default) in one process.

    python tools/torch_flash_ab.py [--seed N]

Needs a CUDA card; imports torch, numpy, the standard library, the port and
tools/cuda_timing.py.
"""
from __future__ import annotations

import argparse
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from tools import cuda_timing  # noqa: E402

cuda_ms = functools.partial(cuda_timing.cuda_ms, iters=20, warmup=3)

CVT = ("MMA_TF32_CVT",)
# (label, n, bias form): the Semantic (table), Fine and Coarse training shapes
SHAPES = (("table", 2049, "table"), ("bias", 1201, "bias"), ("bias", 603, "bias"))


def inputs(rng, n, form, b=4, h=8):
    dev = torch.device("cuda")
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dev)
                  for s in [(b, h, n, 64), (b, 1, n, 64), (b, 1, n, 64), (b, h, n, 64)])
    tab = bias = None
    if form == "table":
        tab = torch.from_numpy(0.5 * rng.standard_normal((2 * n - 1, h), dtype=np.float32)).to(dev)
    else:
        bias = torch.from_numpy(0.5 * rng.standard_normal((h, n, n), dtype=np.float32)).to(dev)
    return q, k, v, g, tab, bias


def kernel_times(q, k, v, g, tab, bias):
    """ms of K1, K2 alone, K2 with the bias's gradient, K3."""
    kw = dict(causal=True, scale=0.125)
    out, lse = fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, causal=True, return_lse=True)
    args = (q, k, v, g, lse, (g * out).sum(-1), tab, None)
    dq = torch.empty_like(q)
    with torch.no_grad():
        fwd = cuda_ms(lambda: fa.flash_attention(q, k, v, bias_tab=tab, bias=bias, causal=True))
    return {"K1": fwd,
            "K2": cuda_ms(lambda: fa._bwd_launch("flash_bwd_dq", (dq, None, None), *args,
                                                 bias=bias, **kw)),
            "K2+grad": cuda_ms(lambda: fa.bwd_dq(*args, bias=bias, **kw)),
            "K3": cuda_ms(lambda: fa.bwd_dkv(*args, bias=bias, **kw))}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    print(f"device: {smi}")
    for label, n, form in SHAPES:
        tensors = inputs(np.random.default_rng(seed), n, form)
        runs = {"int": [], "cvt": []}
        for build in ("int", "cvt", "cvt", "int"):
            if build == "cvt":
                with fa.built_with(CVT):
                    runs[build].append(kernel_times(*tensors))
            else:
                runs[build].append(kernel_times(*tensors))
        for kernel in runs["int"][0]:
            ours, theirs = ([r[kernel] for r in runs[b]] for b in ("int", "cvt"))
            ratio = np.mean(theirs) / np.mean(ours)
            print(f"fp32 4x8x{n}x64 {label} {kernel}: integer rounding "
                  + " ".join(f"{x:.4f}" for x in ours) + " ms | cvt.rna "
                  + " ".join(f"{x:.4f}" for x in theirs) + f" ms | {ratio:.2f}x")


if __name__ == "__main__":
    main()
