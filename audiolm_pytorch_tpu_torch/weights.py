"""Reader of the JAX package's self-describing `.npz` checkpoints, and the map
from its pytree key paths to this package's `state_dict` keys.

The format (written by the JAX package's `training/checkpoint.py`): one
`__meta__` entry holding JSON with `leaf_names` (key paths such as
`.transformer.layers[0][1].to_q.weight`), the optional `bf16_u16_leaves`
(leaves stored as bfloat16 bit patterns in uint16) and the model `config`;
then `leaf_0 ... leaf_{n-1}` in `leaf_names` order. Only numpy is needed to
read it: bfloat16 leaves are reinterpreted as `torch.bfloat16` directly.
Buffer leaves (the codec's codebooks and EMA statistics) carry a literal
`[<flat index 0>]` at the end of their path, which the map drops. The
codec's map also runs the other way (`codec_state_dict_to_jax`), so the
port writes checkpoints the JAX package reads.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

__all__ = ["read_npz", "state_dict_from_jax", "codec_state_dict_from_jax",
           "codec_state_dict_to_jax", "DISCRIMINATORS"]

# slots of one JAX Transformer layer tuple
# (hc_attn, attn, hc_cross, cross, hc_ff, ff); cross attention is not ported
_LAYER_SLOTS = {0: "hc_attn", 1: "attn", 4: "hc_ff", 5: "ff"}
_INDEX = re.compile(r"\[(\d+)\]")
_FLAT_INDEX = re.compile(r"\[<flat index \d+>\]")
_BUFFER_LEAF = "[<flat index 0>]"
# the codec's GAN discriminators (their state_dict keys' prefixes)
DISCRIMINATORS = ("discriminators.", "stft_discriminator.")


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
                t = torch.from_numpy(np.array(a))  # 0-d leaves stay 0-d
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


def _codec_layout(key: str, ndim: int):
    """The permutation from the JAX layout of a codec leaf to the port's:
    Linear weights (in, out) -> (out, in); convolution weights (K, in, out)
    -> (out, in, K), the decoder blocks' transposed ones (`up`) -> (in, out,
    K); the complex convolutions' weights `wr`, `wi` (kh, kw, in, out) ->
    (out, in, kh, kw); None for a leaf kept as it is."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "weight" and ndim == 2:
        return (1, 0)
    if leaf == "weight" and ndim == 3:
        return (1, 2, 0) if key.endswith(".up.weight") else (2, 1, 0)
    if leaf in ("wr", "wi") and ndim == 4:
        return (3, 2, 0, 1)
    return None


def codec_state_dict_from_jax(named_arrays) -> "dict[str, torch.Tensor]":
    """Map {JAX key path: array} of a SoundStream, its discriminators and
    its quantizers' training state included, to the port's state_dict:
    bfloat16 leaves become float32 (the model's type) and each weight takes
    the port's layout (`_codec_layout`)."""
    out = {}
    for path, a in named_arrays.items():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        key = _port_key(path, lm_layers=False)
        if t.dtype == torch.bfloat16:
            t = t.float()
        perm = _codec_layout(key, t.ndim)
        out[key] = (t.permute(*perm) if perm else t).contiguous()
    return out


def codec_state_dict_to_jax(state_dict, buffers=()) -> "dict[str, np.ndarray]":
    """The inverse of `codec_state_dict_from_jax`: {JAX key path: numpy
    array} of a port SoundStream's state_dict, each leaf in the JAX layout;
    the names in `buffers` (the module's buffers) get JAX's buffer suffix.
    The arrays are copies."""
    buffers = set(buffers)
    out = {}
    for key, t in state_dict.items():
        perm = _codec_layout(key, t.ndim)
        if perm:
            t = t.permute(*sorted(range(t.ndim), key=perm.__getitem__))
        path = "." + re.sub(r"\.(\d+)(?=\.|$)", r"[\1]", key)
        out[path + (_BUFFER_LEAF if key in buffers else "")] = \
            t.detach().to("cpu", copy=True).contiguous().numpy()
    return out
