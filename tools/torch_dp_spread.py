"""Sets the data-parallel phase's gaps beside the card's own spread: runs
`chip_smoke.py`'s data-parallel work (two gloo ranks of `chip_smoke.py` on
the one card, then each again with the gradient all-reduce skipped, and
one process on the whole batch), then the one process twice more, once
the same and once with the batch's rows reversed (the same step, its sums
in another order). Prints, for each ranks' run and each extra one-process
run, every gap of `chip_smoke.dp_gaps` to the first one-process run and
the four worst quantizer buffers after each codec step.

    python tools/torch_dp_spread.py [--seed N]

Needs a CUDA card; imports torch, numpy, `chip_smoke.py` and the port.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from audiolm_pytorch_tpu_torch.training import trainer as tr  # noqa: E402


def show(name, res, one):
    gaps = cs.dp_gaps(res, one)
    print(name, " ".join(f"{k} {v:.3e}" for k, v in gaps.items()), flush=True)
    for i, (got, want) in enumerate(zip(res["codec"], one["codec"]), 1):
        per = {k: cs.rel_norm(v, want["buffers"][k]) for k, v in got["buffers"].items()}
        top = sorted(per.items(), key=lambda kv: -kv[1])[:4]
        print(f"  step {i} worst buffers:", " ".join(f"{k} {v:.3e}" for k, v in top))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this tool needs a GPU")
    t0 = time.perf_counter()
    cs.device_phase()
    cs.build_phase()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one, ranks, faults = cs.dp_results(args.seed)
    out = ROOT / "build" / "data_parallel"
    again = cs.dp_run(None, args.seed, out, "results_again")
    stack = tr.SoundStreamTrainer._stack_accum
    tr.SoundStreamTrainer._stack_accum = \
        lambda self, it: np.ascontiguousarray(stack(self, it)[:, ::-1])
    try:
        reversed_rows = cs.dp_run(None, args.seed, out, "results_reversed")
    finally:
        tr.SoundStreamTrainer._stack_accum = stack
    for r, res in enumerate(ranks):
        show(f"rank {r}", res, one)
    for r, res in enumerate(faults):
        show(f"rank {r}, gradient all-reduce skipped", res, one)
    show("one process again", again, one)
    show("one process, rows reversed", reversed_rows, one)
    print(f"done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
