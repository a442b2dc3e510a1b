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
port writes checkpoints the JAX package reads; so does the LMs' map
(`lm_state_dict_to_jax`). `hubert_state_dict_from_jax` carries a JAX
HubertWithKmeans's weights and centres into the port's,
`t5_state_dict_from_jax` a T5Encoder's, `encodec_state_dict_from_jax` an
EncodecWrapper's and `vq_wav2vec_state_dict_from_jax` a FairseqVQWav2Vec's.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

__all__ = ["read_npz", "state_dict_from_jax", "lm_state_dict_to_jax", "lm_jax_path",
           "codec_state_dict_from_jax", "codec_state_dict_to_jax",
           "hubert_state_dict_from_jax", "t5_state_dict_from_jax", "encodec_state_dict_from_jax",
           "vq_wav2vec_state_dict_from_jax", "DISCRIMINATORS"]

# slots of one JAX Transformer layer tuple (hc_attn, attn, hc_cross, cross, hc_ff, ff)
_LAYER_SLOTS = {0: "hc_attn", 1: "attn", 2: "hc_cross", 3: "cross", 4: "hc_ff", 5: "ff"}
_SLOT_INDEX = {name: slot for slot, name in _LAYER_SLOTS.items()}
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
            raise KeyError(f"{path}: no layer slot {slot}")
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


def _jax_path(key: str) -> str:
    """`a.b.0.c` -> `.a.b[0].c`, the JAX key path of a state_dict key."""
    return "." + re.sub(r"\.(\d+)(?=\.|$)", r"[\1]", key)


def lm_state_dict_to_jax(state_dict) -> "dict[str, np.ndarray]":
    """The inverse of `state_dict_from_jax`: {JAX key path: numpy array} of
    an LM's state_dict (`transformer.layers.0.attn.to_q.weight` ->
    `.transformer.layers[0][1].to_q.weight`, Linear weights back to (in,
    out)), float32 copies."""
    out = {}
    for key, t in state_dict.items():
        if key.rsplit(".", 1)[-1] == "weight" and t.ndim == 2:
            t = t.t()
        out[lm_jax_path(key)] = t.detach().to("cpu", torch.float32, copy=True).contiguous().numpy()
    return out


def lm_jax_path(key: str) -> str:
    """The JAX key path of an LM's state_dict key (the layers' named slots
    back to their tuple indices)."""
    key = re.sub(r"\.layers\.(\d+)\.(hc_attn|attn|hc_cross|cross|hc_ff|ff)(?=\.)",
                 lambda m: f".layers.{m.group(1)}.{_SLOT_INDEX[m.group(2)]}", key)
    return _jax_path(key)


def t5_state_dict_from_jax(named_arrays) -> "dict[str, torch.Tensor]":
    """Map {JAX key path: array} of a T5Encoder to the port's state_dict
    (`.blocks[0].q.weight` -> `blocks.0.q.weight`; Linear weights (in, out)
    -> (out, in)), float32."""
    out = {}
    for path, a in named_arrays.items():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        key = _port_key(path, lm_layers=False)
        if key.rsplit(".", 1)[-1] == "weight" and t.ndim == 2 and not key.startswith("token"):
            t = t.t()
        out[key] = t.float().contiguous()
    return out


def hubert_state_dict_from_jax(named_arrays) -> "dict[str, torch.Tensor]":
    """Map {JAX key path: array} of a HubertWithKmeans to the port's
    state_dict: Linear weights (in, out) -> (out, in); the convolutions'
    weights, the positional one included, (K, in, out) -> (out, in, K);
    the centres as they are."""
    out = {}
    for path, a in named_arrays.items():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        key = _port_key(path, lm_layers=False)
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight" and t.ndim == 2:
            t = t.t()
        elif leaf in ("weight", "pos_conv_weight") and t.ndim == 3:
            t = t.permute(2, 1, 0)
        out[key] = t.float().contiguous()
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


# LFQ's and FSQ's projections: a bare (in, out) matrix in JAX, a Linear's
# (out, in) weight in the port
_PROJECTIONS = ("project_in", "project_out")
# integer arrays of LFQ and FSQ that JAX keeps as plain leaves, not Buffers
_PLAIN_INT_LEAVES = ("bit_weights", "basis")


def codec_state_dict_from_jax(named_arrays) -> "dict[str, torch.Tensor]":
    """Map {JAX key path: array} of a SoundStream, its discriminators and
    its quantizers' training state included, to the port's state_dict:
    bfloat16 leaves become float32 (the model's type) and each weight takes
    the port's layout (`_codec_layout`); LFQ's and FSQ's projections
    become Linear weights (`project_in` -> `project_in.weight`,
    transposed)."""
    out = {}
    for path, a in named_arrays.items():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        key = _port_key(path, lm_layers=False)
        if key.rsplit(".", 1)[-1] in _PROJECTIONS:
            key += ".weight"
        if t.dtype == torch.bfloat16:
            t = t.float()
        perm = _codec_layout(key, t.ndim)
        out[key] = (t.permute(*perm) if perm else t).contiguous()
    return out


def codec_state_dict_to_jax(state_dict, buffers=()) -> "dict[str, np.ndarray]":
    """The inverse of `codec_state_dict_from_jax`: {JAX key path: numpy
    array} of a port SoundStream's state_dict, each leaf in the JAX layout;
    the names in `buffers` (the module's buffers) get JAX's buffer suffix,
    but for LFQ's and FSQ's integer arrays, plain leaves in JAX. The
    arrays are copies."""
    buffers = set(buffers)
    out = {}
    for key, t in state_dict.items():
        perm = _codec_layout(key, t.ndim)
        if perm:
            t = t.permute(*sorted(range(t.ndim), key=perm.__getitem__))
        path = _jax_path(key)
        if path.endswith(tuple(f".{p}.weight" for p in _PROJECTIONS)):
            path = path[: -len(".weight")]
        buffer = key in buffers and key.rsplit(".", 1)[-1] not in _PLAIN_INT_LEAVES
        out[path + (_BUFFER_LEAF if buffer else "")] = \
            t.detach().to("cpu", copy=True).contiguous().numpy()
    return out


_LSTM_CELL = re.compile(r"(enc|dec)_lstm\.cells\.(\d+)\.(\d)$")
_LSTM_LEAVES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def encodec_state_dict_from_jax(named_arrays) -> "dict[str, torch.Tensor]":
    """Map {JAX key path: array} of an EncodecWrapper to the port's
    state_dict: convolution weights (K, in, out) -> (out, in, K), the
    decoder's transposed ones (`dec_blocks[i][0]`) -> (in, out, K); each
    LSTM cell's (W_ih, W_hh, b_ih, b_hh), W (in, 4 out) -> (4 out, in), to
    `torch.nn.LSTM`'s `weight_ih_l{j}` ...; the quantizers' state as it
    is."""
    out = {}
    for path, a in named_arrays.items():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        key = _port_key(path, lm_layers=False)
        cell = _LSTM_CELL.match(key)
        if cell:
            side, layer, slot = cell.groups()
            key = f"{side}_lstm.{_LSTM_LEAVES[int(slot)]}_l{layer}"
            t = t.t() if t.ndim == 2 else t
        elif key.endswith(".weight") and t.ndim == 3:
            t = t.permute(1, 2, 0) if re.fullmatch(r"dec_blocks\.\d+\.0\.weight", key) \
                else t.permute(2, 1, 0)
        out[key] = t.float().contiguous() if t.is_floating_point() else t
    return out


def vq_wav2vec_state_dict_from_jax(named_arrays) -> "dict[str, torch.Tensor]":
    """Map {JAX key path: array} of a FairseqVQWav2Vec to the port's
    state_dict: the convolutions' weights (K, in, out) -> (out, in, K); the
    norms, the codewords and the grouped projection (G, in, out) as they
    are."""
    out = {}
    for path, a in named_arrays.items():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
        key = _port_key(path, lm_layers=False)
        if key.startswith("encoder.") and key.endswith(".weight"):
            t = t.permute(2, 1, 0)
        out[key] = t.float().contiguous()
    return out
