"""Checkpoints in the JAX package's `.npz` format (its
`training/checkpoint.py`), written and read with numpy alone: `leaf_0 ...
leaf_{n-1}` in the order of `__meta__.leaf_names` (JSON, with whatever
else the writer adds: the model's config, the step count), bfloat16 leaves
stored as uint16 bit patterns and named in `__meta__.bf16_u16_leaves`
(read here; the port writes float32). A leaf's name is its JAX key path,
such as `['model'].encoder_blocks[0].res1.conv1.weight`; `weights.py` maps
the codec's paths to the port's state_dict keys and back.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..weights import codec_state_dict_from_jax, read_npz

__all__ = ["save_pytree", "read_pytree", "load_pytree_into"]


def _jsonable(v):
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def save_pytree(path, leaves: "dict[str, np.ndarray]", extra_meta: "dict | None" = None):
    """Write {key path: array} in order, with extra_meta in `__meta__`."""
    arrays = {f"leaf_{i}": a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
              else np.asarray(a) for i, a in enumerate(leaves.values())}
    meta = dict(extra_meta or {}, leaf_names=list(leaves))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(_jsonable(meta)).encode(), dtype=np.uint8),
                 **arrays)


def read_pytree(path, prefix: str = "") -> "tuple[dict, dict[str, torch.Tensor]]":
    """(meta, {key path without the prefix: tensor}) of the leaves whose
    path starts with `prefix`; bfloat16 leaves as torch.bfloat16."""
    meta, arrays = read_npz(path)
    return meta, {name[len(prefix):]: a for name, a in arrays.items() if name.startswith(prefix)}


def load_pytree_into(path, codec, prefix: str = ""):
    """Load the leaves under `prefix` into a port SoundStream (its weights,
    discriminators and quantizer state), strictly: every leaf of the model
    and no other. `prefix="['model']"` reads a trainer checkpoint's model,
    `"['ema'].shadow"` its EMA shadow."""
    _, arrays = read_pytree(path, prefix)
    if not arrays:
        raise ValueError(f"no leaves under prefix {prefix!r} in {path}")
    codec.load_state_dict(codec_state_dict_from_jax(arrays))
    return codec
