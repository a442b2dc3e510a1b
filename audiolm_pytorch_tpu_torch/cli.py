"""`audiolm-torch`, the port's command line, held against the JAX package's
`cli.py`: the same subcommands, flags and defaults, and one flag of the
port's, `--device` (default `cuda`; `cpu` runs the plain PyTorch path).

    python -m audiolm_pytorch_tpu_torch.cli [--device cpu] SUBCOMMAND ...

Subcommands:
  info      inspect a checkpoint (.npz): its kind, version and config
  tokenize  waveform (WAV, FLAC or an FFmpeg format) -> codec codes (.npz,
            `codes` int32 (G, B, N, Q))
  decode    codec codes (.npz) -> 16-bit WAV
  generate  the three-stage chain from saved checkpoints -> WAV
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device

__all__ = ["main"]


def cmd_info(args, device):
    """Reads on the host; the device is resolved all the same, as for every
    subcommand."""
    from .weights import read_npz
    meta, _ = read_npz(args.checkpoint)
    # as the JAX package's load_checkpoint: each top-level JSON list a tuple
    config = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in meta.get("config", {}).items()}
    print(json.dumps({"kind": meta.get("kind"), "version": meta.get("version"),
                      "config": {k: str(v) for k, v in config.items()}}, indent=2))


def _codec(args, device):
    from .models.soundstream import load_soundstream
    return load_soundstream(args.codec, device=device, discriminators=False).eval()


@torch.no_grad()
def cmd_tokenize(args, device):
    from .utils.audio_io import load_audio
    codec = _codec(args, device)
    wav, sr = load_audio(args.audio)
    codes = codec.tokenize(torch.from_numpy(wav.mean(0))[None].to(device), input_sample_hz=sr)
    codes = codes.cpu().numpy().astype(np.int32)
    np.savez(args.output, codes=codes)
    print(f"wrote codes {codes.shape} to {args.output}")


@torch.no_grad()
def cmd_decode(args, device):
    from .utils.audio_io import save_audio
    codec = _codec(args, device)
    codes = torch.from_numpy(np.load(args.codes)["codes"]).to(device, torch.long)
    wav = codec.decode_from_codebook_indices(codes)
    save_audio(args.output, wav[0].float().cpu().numpy(), codec.target_sample_hz)
    print(f"wrote {args.output}")


@torch.no_grad()
def cmd_generate(args, device):
    from .models.audiolm import AudioLM
    from .models.hubert import HubertWithKmeans
    from .models.lm import (load_coarse_transformer, load_fine_transformer,
                            load_semantic_transformer)
    from .utils.audio_io import save_audio

    generator = torch.Generator(device=device).manual_seed(args.seed)
    codec = _codec(args, device)
    wav2vec = HubertWithKmeans(checkpoint_path=args.hubert_checkpoint,
                               kmeans_path=args.hubert_kmeans, device=device)
    audiolm = AudioLM(wav2vec=wav2vec, codec=codec,
                      semantic_transformer=load_semantic_transformer(args.semantic, device=device),
                      coarse_transformer=load_coarse_transformer(args.coarse, device=device),
                      fine_transformer=load_fine_transformer(args.fine, device=device))
    wave = audiolm(batch_size=args.batch_size,
                   text=[args.text] * args.batch_size if args.text else None,
                   prime_wave_path=args.prime_wave, max_length=args.max_length,
                   generator=generator)
    waves = wave if isinstance(wave, list) else list(wave)
    out = Path(args.output)
    for i, w in enumerate(waves):
        if w is None:
            continue
        path = out if len(waves) == 1 else out.with_stem(f"{out.stem}_{i}")
        save_audio(path, w.float().cpu().numpy(), codec.target_sample_hz)
        print(f"wrote {path}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="audiolm-torch",
                                description="AudioLM CLI of the PyTorch/CUDA port")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch path)")
    sub = p.add_subparsers(dest="cmd", required=True)

    gi = sub.add_parser("info", help="inspect a checkpoint")
    gi.add_argument("checkpoint")
    gi.set_defaults(fn=cmd_info)

    gt = sub.add_parser("tokenize", help="waveform -> codec codes")
    gt.add_argument("--codec", required=True)
    gt.add_argument("--audio", required=True)
    gt.add_argument("--output", default="codes.npz")
    gt.set_defaults(fn=cmd_tokenize)

    gd = sub.add_parser("decode", help="codec codes -> waveform")
    gd.add_argument("--codec", required=True)
    gd.add_argument("--codes", required=True)
    gd.add_argument("--output", default="decoded.wav")
    gd.set_defaults(fn=cmd_decode)

    gg = sub.add_parser("generate", help="3-stage text/prime-conditioned generation")
    gg.add_argument("--codec", required=True, help="SoundStream checkpoint (.npz)")
    gg.add_argument("--semantic", required=True)
    gg.add_argument("--coarse", required=True)
    gg.add_argument("--fine", required=True)
    gg.add_argument("--hubert-checkpoint", default=None)
    gg.add_argument("--hubert-kmeans", default=None)
    gg.add_argument("--text", default=None)
    gg.add_argument("--prime-wave", default=None)
    gg.add_argument("--max-length", type=int, default=2048)
    gg.add_argument("--batch-size", type=int, default=1)
    gg.add_argument("--seed", type=int, default=0)
    gg.add_argument("--output", default="generated.wav")
    gg.set_defaults(fn=cmd_generate)

    args = p.parse_args(argv)
    device = resolve_device(args.device)
    return args.fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
