"""Ablations of float32's chunked K2 and K3 at head dim 256 (csrc/flash_bwd.cu's
`flash_bwd_dq_chunk_kernel` and `flash_bwd_dkv_chunk_kernel`): edited copies
of the source, each with one part of the two kernels left out, built side by
side and timed on the device (torch.profiler, the kernels' own time) at the
256-wide flagship's training shape (table) and the Coarse LM's (bias). A
variant's results are wrong where it leaves a part out: only its time is
read. The variants:

    base        the source as it stands
    noload      the streamed chunks' TMA loads (their barrier arrives at once)
    nosplit     the chunks' splits into tf32 pairs (plain and transposed)
    noproducts  the products whose N index is D (dq, dV, dK)
    onechunk    K3's query-range split of the chunked form (dkv_plan's rule)

    python tools/torch_flash_ablate.py [--variants base,noload,...]

Needs a CUDA card and nvcc; writes the copies into csrc/ while they build and
removes them again.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from audiolm_pytorch_tpu_torch.ops.kernels import _build  # noqa: E402
from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from tools import cuda_timing  # noqa: E402
from tools.torch_flash_parent_ab import inputs  # noqa: E402

# the chunked kernels' part of the source, which the edits touch
FIRST = "template <int D, bool SUM>\nstruct DqChunk {"
LAST = "// K2's block and kernel: Dq's, or"
QSPLIT = ("  if (f32 && d == F32_DIM && base < 2 * PLAN_SMS)\n"
          "    qsplit = max(qsplit, min((int)((2 * PLAN_SMS + base - 1) / base), (n + BQ - 1) / BQ / 2));\n")
# variant: [(old, new), ...] within the chunked kernels, or over the source
EDITS = {
    "noload": [("wg::mbar_arrive_tx(&loaded[s], wg::CHUNK_BYTES);",
                "wg::mbar_arrive(&loaded[s]); if (tid < 0)")],
    "nosplit": [("if (i % PER < 2 * NCH) wg::split_tile<wg::CHUNK_BYTES>(Xh(s), Xl(s), tid, 128);\n"
                 "      else wg::split_tile_t(Xh(s), Xl(s), tid, 3);", ""),
                ("if (transposed) wg::split_tile_t(xh, xl, ctid, 2 + s);\n"
                 "    else wg::split_tile<wg::CHUNK_BYTES>(xh, xl, ctid, 128);", "")],
    "noproducts": [("wg::add_pk_chunk<D>(", "if (threadIdx.x > 1024) wg::add_pk_chunk<D>(")],
}
SHAPES = (("4x4x2049x256 table (flagship training)", 4, 4, 2049, "table"),
          ("4x2x603x256 bias (Coarse training)", 4, 2, 603, "bias"))


def variant_source(base: str, name: str) -> str:
    if name == "base":
        return base
    if name == "onechunk":
        assert base.count(QSPLIT) == 1, "dkv_plan's rule of the chunked form"
        return base.replace(QSPLIT, "")
    a, b = base.index(FIRST), base.index(LAST)
    part = base[a:b]
    for old, new in EDITS[name]:
        assert old in part, (name, old)
        part = part.replace(old, new)
    return base[:a] + part + base[b:]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default="base,noload,nosplit,noproducts,onechunk")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    names = args.variants.split(",")
    base = (_build.CSRC / fa.SOURCE_BWD).read_text()
    files = {}
    for name in names:
        files[name] = f"flash_bwd_ablate_{name}.cu"
        (_build.CSRC / files[name]).write_text(variant_source(base, name))
    try:
        with ThreadPoolExecutor(len(files)) as pool:
            list(pool.map(_build.load, files.values()))
    finally:
        for f in files.values():
            (_build.CSRC / f).unlink()
    f32, d = torch.float32, 256
    for label, b, h, n, form in SHAPES:
        q, k, v, g, tab, bias, mask = inputs(np.random.default_rng(0), f32, b, h, n, n, form,
                                             "forget", d)
        tabc, kmask, dense = fa._kernel_args(tab, mask, bias)
        kw = dict(causal=True, scale=d ** -0.5, bias=dense)
        with torch.no_grad():
            out, lse = fa.fwd(q, k, v, tabc, kmask, **kw)
        bargs = (q, k, v, g, lse, (g.float() * out.float()).sum(-1), tabc, kmask)
        saved = fa.SOURCE_BWD
        # in turns: every variant, then every variant again in reverse
        for name in names + names[::-1]:
            fa.SOURCE_BWD = files[name]
            try:
                dq = cuda_timing.named_device_ms(lambda: fa.bwd_dq(*bargs, **kw),
                                                 ["flash_bwd_dq_chunk_kernel", "dtab_sum_kernel"])
                dkv = cuda_timing.named_device_ms(lambda: fa.bwd_dkv(*bargs, **kw),
                                                  ["flash_bwd_dkv_chunk_kernel", "dkv_sum_kernel"])
            finally:
                fa.SOURCE_BWD = saved
            print(f"ablate [{label}] {name}: K2 with its bias gradient {dq[0]:.4f} ms, K3 "
                  f"{dkv[0]:.4f} ms on the device", flush=True)


if __name__ == "__main__":
    main()
