"""Checkpoints in the JAX package's `.npz` format (its
`training/checkpoint.py`), written and read with numpy alone: `leaf_0 ...
leaf_{n-1}` in the order of `__meta__.leaf_names` (JSON, with whatever
else the writer adds: the model's config, the step count), bfloat16 leaves
stored as uint16 bit patterns and named in `__meta__.bf16_u16_leaves`
(float32 unless `bf16=True`; `compress=True` deflates the zip). A leaf's
name is its JAX key path, such as
`['model'].encoder_blocks[0].res1.conv1.weight`; `weights.py` maps the
codec's and the LMs' paths to the port's state_dict keys and back.

`save_checkpoint` writes a model alone (its config, version, kind), which the
JAX package's `load_checkpoint` restores and the port's `load_*` read;
`persist_model_from` cuts a trainer checkpoint down to its model (bfloat16,
compressed), as JAX's `tools/persist_ckpt.py` does.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..weights import (codec_state_dict_from_jax, codec_state_dict_to_jax, lm_state_dict_to_jax,
                       read_npz)

__all__ = ["save_pytree", "read_pytree", "load_pytree_into", "save_checkpoint",
           "persist_model_from"]


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


def _bf16_bits(a):
    """uint16 bit patterns of a's values rounded to bfloat16 (to nearest,
    ties to even, as numpy's ml_dtypes rounds)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16) \
        .view(torch.int16).numpy().view(np.uint16)


def save_pytree(path, leaves: "dict[str, np.ndarray]", extra_meta: "dict | None" = None, *,
                bf16: bool = False, compress: bool = False, bf16_leaves=()):
    """Write {key path: array} in order, with extra_meta in `__meta__`; with
    bf16, the float leaves as bfloat16 bit patterns; the leaves named in
    bf16_leaves are such bit patterns already."""
    arrays, bf16_names = {}, list(bf16_leaves)
    for i, (name, a) in enumerate(leaves.items()):
        a = a.detach().cpu() if isinstance(a, torch.Tensor) else a
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            a = a.view(torch.int16).numpy().view(np.uint16)
            bf16_names.append(name)
        a = np.asarray(a)
        if bf16 and a.dtype in (np.float32, np.float64):
            a = _bf16_bits(a)
            bf16_names.append(name)
        arrays[f"leaf_{i}"] = a
    meta = dict(extra_meta or {}, leaf_names=list(leaves))
    if bf16_names:
        meta["bf16_u16_leaves"] = bf16_names
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    saver = np.savez_compressed if compress else np.savez
    with open(path, "wb") as f:
        saver(f, __meta__=np.frombuffer(json.dumps(_jsonable(meta)).encode(), dtype=np.uint8),
              **arrays)


def _model_leaves(model):
    """{JAX key path: array} of a port SoundStream or LM."""
    from ..models.soundstream import SoundStream
    if isinstance(model, SoundStream):
        return codec_state_dict_to_jax(model.state_dict(), [n for n, _ in model.named_buffers()])
    return lm_state_dict_to_jax(model.state_dict())


def save_checkpoint(path, model, *, config: "dict | None" = None, version: "str | None" = None,
                    kind: "str | None" = None, extra: "dict | None" = None, bf16: bool = False,
                    compress: bool = False):
    """A port SoundStream or LM alone, as the JAX package's `save_checkpoint`
    writes a model: its leaves by JAX key path, with `config` (the model's
    own by default), `version`, `kind` and `extra` in the meta."""
    meta = {"config": config if config is not None else getattr(model, "config", {}),
            "version": version, "kind": kind}
    if extra:
        meta["extra"] = extra
    save_pytree(path, _model_leaves(model), extra_meta=meta, bf16=bf16, compress=compress)


def persist_model_from(in_path, out_path, prefix: str = "['model']", bf16: bool = True):
    """A trainer checkpoint of either package cut down to the leaves under
    `prefix`, re-rooted (so the model loaders read it), floats as bfloat16
    with bf16, compressed, the meta (config, kind, steps) carried over with
    `persisted_from`. Returns out_path."""
    with np.load(in_path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        names = meta["leaf_names"]
        old_bf16 = set(meta.get("bf16_u16_leaves", ()))
        sel = [(i, n[len(prefix):]) for i, n in enumerate(names) if n.startswith(prefix)]
        if not sel:
            raise ValueError(f"no leaves under prefix {prefix!r} in {in_path}")
        leaves = {n: data[f"leaf_{i}"] for i, n in sel}
        kept_bf16 = [n for i, n in sel if names[i] in old_bf16]
    new_meta = {k: v for k, v in meta.items() if k not in ("leaf_names", "bf16_u16_leaves")}
    new_meta["persisted_from"] = str(in_path)
    save_pytree(out_path, leaves, extra_meta=new_meta, bf16=bf16, compress=True,
                bf16_leaves=kept_bf16)
    return Path(out_path)


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
