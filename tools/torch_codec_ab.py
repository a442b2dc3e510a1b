"""Times the codec's two kernels and its round trip for two checkouts of the
port on one card, in turns (A, B, B, A), each run in a process of its own:
K6 (nearest-code search) at the codec's shape, 800 x 512 against 1024 x 512;
K7 (blocked local attention) at the codec's 8 x 8 x 100 x 64 and the 10-s
8 x 8 x 500 x 64, window 128, in float32 and bf16; each by CUDA events over
the wrapper's calls and as device time per call under torch.profiler; then
the SoundStream codec at bench.py's width (AudioLMSoundStream(codebook_size=
1024), random weights and codebooks from --seed, float32, TF32 off): the
tokenize -> decode_from_codebook_indices round trip of 8 clips of 2 s, ms
per call by the host clock over 10 warm calls, and one call's device-busy
time under torch.profiler. The timers are those of tools/cuda_timing.py,
which chip_smoke.py uses too.

    python tools/torch_codec_ab.py --a PATH --b PATH [--seed N]
    python tools/torch_codec_ab.py --tree PATH [--seed N]   # one run, one JSON line

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
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools.cuda_timing import cuda_ms, device_per_call  # noqa: E402

CODEC_B, CODEC_S, SR = 8, 2, 16000
ROWS = CODEC_B * CODEC_S * 50  # one quantizer's rows: 50 frames a second


def run_tree(path: str, seed: int) -> dict:
    sys.path.insert(0, path)
    from audiolm_pytorch_tpu_torch import AudioLMSoundStream
    from audiolm_pytorch_tpu_torch.ops.kernels import local_attention as la
    from audiolm_pytorch_tpu_torch.ops.kernels import vq

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    out = {"tree": path}
    x = torch.from_numpy(rng.standard_normal((ROWS, 512), dtype=np.float32)).to(dev)
    cb = torch.from_numpy(rng.standard_normal((1024, 512), dtype=np.float32)).to(dev)
    out["k6"] = {"ms": cuda_ms(lambda: vq.vq_nearest_code(x, cb), iters=20, warmup=3),
                 "device_ms": device_per_call(lambda: vq.vq_nearest_code(x, cb))[0]}
    for dtype, name in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for t, label in ((100, "2 s"), (500, "10 s")):
            q, k, v = (torch.from_numpy(rng.standard_normal((8, 8, t, 64), dtype=np.float32))
                       .to(dev, dtype) for _ in range(3))

            def call():
                return la.local_attention(q, k, v, window_size=128, scale=8.0 / 64)

            out[f"k7 {name} {label}"] = {"ms": cuda_ms(call, iters=20, warmup=3),
                                         "device_ms": device_per_call(call)[0]}
    codec = AudioLMSoundStream(codebook_size=1024, seed=seed, device=dev).eval()
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for rvq in codec.rq.rvqs:
            for layer in rvq.layers:
                layer.codebook.copy_(torch.randn(layer.codebook.shape, generator=gen, device=dev))
        wave = torch.from_numpy(0.1 * rng.standard_normal((CODEC_B, CODEC_S * SR),
                                                          dtype=np.float32)).to(dev)

        def round_trip():
            return codec.decode_from_codebook_indices(codec.tokenize(wave))

        round_trip()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            round_trip()
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) / 10 * 1e3
        busy = device_per_call(round_trip, 1)[0]
    out["codec"] = {"ms": call_ms, "busy_ms": busy}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--a")
    parser.add_argument("--b")
    parser.add_argument("--tree")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    if args.tree:
        print(json.dumps(run_tree(args.tree, args.seed)))
        return
    runs = []
    for tree in (args.a, args.b, args.b, args.a):
        proc = subprocess.run([sys.executable, __file__, "--tree", tree, "--seed", str(args.seed)],
                              capture_output=True, text=True, check=True)
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"A = {args.a}, B = {args.b}; columns A, B, B, A")
    for key in runs[0]:
        if key == "tree":
            continue
        for metric in runs[0][key]:
            vals = " ".join(f"{r[key][metric]:.4f}" for r in runs)
            print(f"{key} {metric}: {vals}")
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
