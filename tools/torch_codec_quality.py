"""Held-out SI-SNR of a persisted codec through the PyTorch port, on the
validation split of bench.py's `bench_codec_quality` (26 clips of 1 s,
replayed from the corpus stream, numpy seed 0, and the trainer's seed-42
split), with the JAX package's value on the same clips beside it on
request.

    python tools/torch_codec_quality.py [--ckpt persist/soundstream_r5_73k.npz]
        [--device cuda|cpu] [--jax]

--jax runs the JAX package on the CPU (float32 at its highest matmul
precision, the quantizer on its CPU path) for the comparison; the port's
side imports no JAX.
"""
from __future__ import annotations

import argparse
import random
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

from audiolm_pytorch_tpu_torch import load_soundstream, si_snr  # noqa: E402


def held_out_clips(n_clips=1300, valid_frac=0.02, max_len=16000):
    from train_codec_corpus import synth_clip
    idx = list(range(n_clips))
    random.Random(42).shuffle(idx)  # the trainer's split
    valid = set(idx[: max(1, int(n_clips * valid_frac))])
    rng = np.random.default_rng(0)  # the corpus stream
    clips = [c[:max_len] for i in range(n_clips) for c in [synth_clip(rng)] if i in valid]
    return np.stack(clips).astype(np.float32)


def port_si_snr(ckpt, x, device):
    model = load_soundstream(ckpt, device=device, discriminators=False).eval()  # serving
    out = []
    with torch.no_grad():
        for i in range(0, len(x), 8):
            xb = torch.from_numpy(x[i: i + 8]).to(device)
            out.append(si_snr(model(xb, return_recons_only=True), xb).cpu().numpy())
    return np.concatenate(out)


def jax_si_snr(ckpt, x):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp
    from audiolm_pytorch_tpu.models.soundstream import SoundStream
    from audiolm_pytorch_tpu.training.checkpoint import load_checkpoint
    from audiolm_pytorch_tpu.utils.metrics import si_snr as j_si_snr
    pkg = load_checkpoint(str(ckpt))
    model = pkg["restore"](jax.eval_shape(lambda: SoundStream(**pkg["config"],
                                                              key=jax.random.PRNGKey(0))))
    fwd = jax.jit(lambda m, b: m(b, return_recons_only=True))
    return np.concatenate([np.asarray(j_si_snr(fwd(model, jnp.asarray(x[i: i + 8])),
                                               jnp.asarray(x[i: i + 8])))
                           for i in range(0, len(x), 8)])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", default=str(ROOT / "persist" / "soundstream_r5_73k.npz"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--jax", action="store_true")
    args = parser.parse_args()
    x = held_out_clips()
    port = port_si_snr(args.ckpt, x, args.device)
    print(f"port ({args.device}): held-out SI-SNR {port.mean():.4f} dB over {len(x)} clips")
    if args.jax:
        ref = jax_si_snr(args.ckpt, x)
        print(f"JAX package (CPU): {ref.mean():.4f} dB; largest per-clip difference "
              f"{np.abs(port - ref).max():.2e} dB")


if __name__ == "__main__":
    main()
