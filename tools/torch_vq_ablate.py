"""Where K6's time goes on one card: the nearest-code search of
`csrc/vq.cu` against copies of it with one part of its chunk loop taken
out (results wrong on purpose; only the time is read), each built as a
library of its own and timed in turns in one process:

  no_mma    the products (the mma.sync of every chunk) replaced by one add;
  no_split  the pass that splits each chunk into tf32 pairs removed;
  no_load   the cp.async copies of each chunk removed;
  no_both   the split pass and the products both out.

Device time per call (torch.profiler, 50 calls) at the codec's shape (800
rows of 512 against 1024 codes), at 1 and 1300 rows, and over D in {32,
128, 1024}, where D / 32 is the number of chunks a block runs in sequence.

    python tools/torch_vq_ablate.py

Needs a CUDA card; imports torch, the standard library, the port and
tools/cuda_timing.py. The
copies are written into `audiolm_pytorch_tpu_torch/csrc/` for the build and
removed again.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from audiolm_pytorch_tpu_torch.ops.kernels import _build, vq  # noqa: E402
from tools.cuda_timing import device_per_call  # noqa: E402

MMA = "        tc::mma2(part[jb], part[jb + 1], a, b);\n"
NO_MMA = "        part[jb][0] += __uint_as_float(a.hi[0] ^ b[0].hi[0] ^ b[1].lo[1] ^ a.lo[3]);\n"
LOADS = ("          tc::cp_async16(dst + r * RP + k - k0, src, in);\n",
         "          tc::cp_async4(dst + r * RP + k - k0, src, in);\n")
SPLIT_FROM, SPLIT_TO = "    // the split pass", "    __syncthreads();  // the split chunk is in"
SHAPES = ((800, 1024, 512), (1, 1024, 512), (1300, 1024, 512), (800, 1024, 32),
          (800, 1024, 128), (800, 1024, 1024))


def variants(src: str) -> dict:
    for part in (MMA, *LOADS, SPLIT_FROM, SPLIT_TO):
        if part not in src:
            raise SystemExit(f"csrc/vq.cu no longer holds {part.strip()!r}: update this tool")
    no_split = src[:src.index(SPLIT_FROM)] + src[src.index(SPLIT_TO):]
    no_load = src
    for line in LOADS:
        no_load = no_load.replace(line, "")
    return {"base": src, "no_mma": src.replace(MMA, NO_MMA), "no_split": no_split,
            "no_load": no_load, "no_both": no_split.replace(MMA, NO_MMA)}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    names, source = {}, vq.SOURCE
    try:
        for key, text in variants((_build.CSRC / vq.SOURCE).read_text()).items():
            names[key] = f"vq_ablate_{key}.cu"
            (_build.CSRC / names[key]).write_text(text)
            _build.load(names[key])
        gen = torch.Generator(device="cuda").manual_seed(0)
        print(f"device us per call: {' | '.join(names)}")
        for n, c, d in SHAPES:
            x = torch.randn(n, d, device="cuda", generator=gen)
            cb = torch.randn(c, d, device="cuda", generator=gen)
            row = []
            for key, name in names.items():
                vq.SOURCE = name
                ms = device_per_call(lambda: vq.vq_nearest_code(x, cb), iters=50)[0]
                row.append(f"{1e3 * ms:.1f}")
            print(f"n={n} c={c} d={d} ({-(-d // 32)} chunks): {' | '.join(row)}", flush=True)
    finally:
        vq.SOURCE = source
        for name in names.values():
            (_build.CSRC / name).unlink(missing_ok=True)


if __name__ == "__main__":
    main()
