"""The port's `save_checkpoint` and `persist_model_from` against the JAX
package's on the CPU: a port SoundStream (the tiny codec) and a port
SemanticTransformer saved by the port (float32, and bfloat16 compressed)
restore through JAX's `load_checkpoint` into a JAX module built by shape,
leaf for leaf; JAX's `save_checkpoint` of the same models loads through the
port's loaders; and `persist_model_from` of one trainer checkpoint writes,
in either package, the same leaves, names and meta, which the other
package's loaders read.

Exact: float32 leaves bit for bit; bfloat16 leaves as numpy's ml_dtypes
rounds them (to nearest, ties to even)."""
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
from audiolm_pytorch_tpu.training import checkpoint as jckpt

from audiolm_pytorch_tpu_torch import (SemanticTransformer, SoundStream, load_semantic_transformer,
                                       load_soundstream)
from audiolm_pytorch_tpu_torch.training import checkpoint as pckpt
from audiolm_pytorch_tpu_torch.weights import codec_state_dict_to_jax, lm_state_dict_to_jax

from tests.test_soundstream import tiny_soundstream
from tests.test_torch_codec import TINY
from torch_port_util import jax_named, jax_replace

LM = dict(dim=32, depth=1, heads=2, dim_head=16, num_semantic_tokens=20)


def _codec_leaves(m):
    return codec_state_dict_to_jax(m.state_dict(), [n for n, _ in m.named_buffers()])


def _models(kind):
    """(port model, its JAX leaves, a JAX module of its shape, the port loader)."""
    if kind == "codec":
        pm = SoundStream(**TINY, device="cpu")
        with torch.no_grad():
            for i, p in enumerate(pm.parameters()):
                p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(i)))
        shapes = jax.eval_shape(lambda: tiny_soundstream(key=jax.random.PRNGKey(0)))
        return pm, _codec_leaves(pm), shapes, load_soundstream
    pm = SemanticTransformer(**LM, seed=3, device="cpu")
    shapes = jax.eval_shape(lambda: JSemantic(**LM, key=jax.random.PRNGKey(0)))
    return pm, lm_state_dict_to_jax(pm.state_dict()), shapes, load_semantic_transformer


def _bf16(a):
    return np.asarray(a).astype(ml_dtypes.bfloat16).astype(np.float32) \
        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("kind", ["codec", "semantic"])
def test_saved_models_load_in_either_package(kind, bf16, tmp_path):
    pm, leaves, shapes, loader = _models(kind)
    path = tmp_path / "port.npz"
    pckpt.save_checkpoint(path, pm, version="v", kind=kind, extra={"note": 1}, bf16=bf16,
                          compress=bf16)
    ckpt = jckpt.load_checkpoint(str(path))
    assert (ckpt["kind"], ckpt["version"], ckpt["extra"]) == (kind, "v", {"note": 1})
    restored = jax_named(ckpt["restore"](shapes))
    assert set(restored) == set(leaves)
    for name, want in leaves.items():
        np.testing.assert_array_equal(np.asarray(restored[name], np.float32)
                                      if bf16 else restored[name],
                                      _bf16(want) if bf16 else want, err_msg=name)
    # JAX's save of the same model, read by the port's loader
    jm = jax_replace(shapes, leaves)
    jpath = tmp_path / "jax.npz"
    jckpt.save_checkpoint(str(jpath), jm, config=pm.config, bf16=bf16, compress=bf16)
    back = loader(jpath, device="cpu")
    got = _codec_leaves(back) if kind == "codec" else lm_state_dict_to_jax(back.state_dict())
    for name, want in leaves.items():
        np.testing.assert_array_equal(got[name], _bf16(want) if bf16 else want, err_msg=name)


def test_persisted_models_are_the_same_file_in_either_package(tmp_path):
    pm, leaves, shapes, loader = _models("semantic")
    trainer = tmp_path / "semantic.transformer.3.ckpt.npz"
    opt = {"['opt'][0].count": np.asarray(3, np.int32)}
    pckpt.save_pytree(trainer, {**{f"['model']{k}": v for k, v in leaves.items()}, **opt},
                      extra_meta={"steps": 3, "kind": "semantic", "config": pm.config})
    port_out = pckpt.persist_model_from(trainer, tmp_path / "port.npz")
    jax_out = jckpt.persist_model_from(str(trainer), str(tmp_path / "jax.npz"))
    with np.load(port_out) as a, np.load(jax_out) as b:
        meta_a, meta_b = (json.loads(bytes(d["__meta__"].tobytes())) for d in (a, b))
        assert meta_a == meta_b and meta_a["steps"] == 3 and "['opt']" not in str(meta_a)
        assert sorted(meta_a["bf16_u16_leaves"]) == sorted(leaves)
        for i in range(len(meta_a["leaf_names"])):
            np.testing.assert_array_equal(a[f"leaf_{i}"], b[f"leaf_{i}"])
    restored = jax_named(jckpt.load_checkpoint(str(port_out))["restore"](shapes))
    back = lm_state_dict_to_jax(loader(jax_out, device="cpu").state_dict())
    for name, want in leaves.items():
        np.testing.assert_array_equal(np.asarray(restored[name], np.float32), _bf16(want))
        np.testing.assert_array_equal(back[name], _bf16(want), err_msg=name)
    with pytest.raises(ValueError, match="no leaves"):
        pckpt.persist_model_from(trainer, tmp_path / "none.npz", prefix="['ema']")
