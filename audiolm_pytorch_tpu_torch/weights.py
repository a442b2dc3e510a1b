"""Reader of the JAX package's self-describing `.npz` checkpoints, and the map
from its pytree key paths to this package's `state_dict` keys.

The format (written by the JAX package's `training/checkpoint.py`): one
`__meta__` entry holding JSON with `leaf_names` (key paths such as
`.transformer.layers[0][1].to_q.weight`), the optional `bf16_u16_leaves`
(leaves stored as bfloat16 bit patterns in uint16) and the model `config`;
then `leaf_0 ... leaf_{n-1}` in `leaf_names` order. Only numpy is needed to
read it: bfloat16 leaves are reinterpreted as `torch.bfloat16` directly.
Buffer leaves (the codec's codebooks and EMA statistics) carry a literal
`[<flat index 0>]` at the end of their path, which the map drops.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

__all__ = ["read_npz", "state_dict_from_jax", "codec_state_dict_from_jax", "CODEC_UNUSED"]

# slots of one JAX Transformer layer tuple
# (hc_attn, attn, hc_cross, cross, hc_ff, ff); cross attention is not ported
_LAYER_SLOTS = {0: "hc_attn", 1: "attn", 4: "hc_ff", 5: "ff"}
_INDEX = re.compile(r"\[(\d+)\]")
_FLAT_INDEX = re.compile(r"\[<flat index \d+>\]")
# the codec's modules that serving does not use (the GAN discriminators)
CODEC_UNUSED = ("discriminators.", "stft_discriminator.")


def read_npz(path) -> "tuple[dict, dict[str, torch.Tensor]]":
    """Return (meta, {key path: tensor}) with bfloat16 leaves as bfloat16."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        bf16 = set(meta.get("bf16_u16_leaves", ()))
        arrays = {}
        for i, name in enumerate(meta["leaf_names"]):
            a = data[f"leaf_{i}"]
            if name in bf16:
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(a))
            arrays[name] = t
    return meta, arrays


def _port_key(path: str, lm_layers: bool = True) -> str:
    """`.transformer.layers[0][1].to_q.weight` -> `transformer.layers.0.attn.to_q.weight`
    (with lm_layers, the LM transformer's layer tuples become named slots;
    else `.layers[0][1]` -> `.layers.0.1`)."""
    path = _FLAT_INDEX.sub("", path)

    def layer_slot(m):
        slot = int(m.group(2))
        if slot not in _LAYER_SLOTS:
            raise KeyError(f"{path}: layer slot {slot} (cross attention) is not ported")
        return f".layers.{m.group(1)}.{_LAYER_SLOTS[slot]}"

    key = re.sub(r"\.layers\[(\d+)\]\[(\d+)\]", layer_slot, path) if lm_layers else path
    key = _INDEX.sub(lambda m: f".{m.group(1)}", key)
    return key.lstrip(".")


def state_dict_from_jax(named_arrays) -> "dict[str, torch.Tensor]":
    """Map {JAX key path: array} to this package's state_dict. Linear weights
    are stored (in, out) by JAX and become (out, in)."""
    out = {}
    for path, a in named_arrays.items():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        key = _port_key(path)
        if key.rsplit(".", 1)[-1] == "weight" and t.ndim == 2:
            t = t.t()
        out[key] = t.contiguous()
    return out


def codec_state_dict_from_jax(named_arrays) -> "dict[str, torch.Tensor]":
    """Map {JAX key path: array} of a SoundStream to the port's state_dict:
    bfloat16 leaves become float32 (the model's type), Linear weights (in,
    out) become (out, in), convolution weights (K, in, out) become
    (out, in, K), and the decoder blocks' transposed convolutions (`up`)
    (in, out, K). The discriminators (`CODEC_UNUSED`) are dropped."""
    out = {}
    for path, a in named_arrays.items():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        key = _port_key(path, lm_layers=False)
        if key.startswith(CODEC_UNUSED):
            continue
        if t.dtype == torch.bfloat16:
            t = t.float()
        if key.rsplit(".", 1)[-1] == "weight":
            if t.ndim == 2:
                t = t.t()
            elif t.ndim == 3:
                t = t.permute(1, 2, 0) if key.endswith(".up.weight") else t.permute(2, 1, 0)
        out[key] = t.contiguous()
    return out
