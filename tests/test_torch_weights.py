"""The port's weight bridge: its numpy-only `.npz` reader against the JAX
package's `load_checkpoint`, and `state_dict_from_jax` covering every JAX leaf
of the flagship and semantic_r5 models."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
from audiolm_pytorch_tpu.training.checkpoint import load_checkpoint

from audiolm_pytorch_tpu_torch import SemanticTransformer, read_npz, state_dict_from_jax

from torch_port_util import jax_named

R5 = Path(__file__).resolve().parents[1] / "persist" / "semantic_r5.npz"
FLAGSHIP = dict(dim=1024, depth=6, heads=8, num_semantic_tokens=500)  # __graft_entry__.entry()


def _jax_shapes(**cfg):
    """{key path: shape} of a JAX SemanticTransformer, without computing it."""
    tree = jax.eval_shape(lambda: JSemantic(**cfg, key=jax.random.PRNGKey(0)))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): x.shape for p, x in flat}


def _port_config(cfg):
    keys = ("dim", "depth", "heads", "num_semantic_tokens", "dim_head", "num_residual_streams")
    return {k: cfg[k] for k in keys if k in cfg}


@pytest.mark.parametrize("which", ["flagship", "semantic_r5"])
def test_state_dict_covers_every_jax_leaf(which):
    cfg = FLAGSHIP if which == "flagship" else read_npz(R5)[0]["config"]
    shapes = _jax_shapes(**cfg)
    mapped = state_dict_from_jax({k: torch.empty(s, device="meta") for k, s in shapes.items()})
    port = SemanticTransformer(**_port_config(cfg), device="cpu").state_dict()
    assert len(mapped) == len(shapes)
    assert set(mapped) == set(port), (set(mapped) ^ set(port))
    for key, t in mapped.items():
        assert t.shape == port[key].shape, key


def test_reader_matches_jax_load_checkpoint():
    meta, arrays = read_npz(R5)
    ckpt = load_checkpoint(R5)
    assert meta["config"]["dim"] == ckpt["config"]["dim"]
    jm = ckpt["restore"](JSemantic(**ckpt["config"], key=jax.random.PRNGKey(0)))
    ref = jax_named(jm)
    assert set(arrays) == set(ref)
    assert any(a.dtype == torch.bfloat16 for a in arrays.values())
    for name, a in arrays.items():
        np.testing.assert_array_equal(a.float().numpy(), ref[name].astype(np.float32), name)


def test_loaded_model_holds_the_checkpoint():
    meta, arrays = read_npz(R5)
    sd = state_dict_from_jax(arrays)
    port = SemanticTransformer(**_port_config(meta["config"]), device="cpu")
    port.load_state_dict(sd)
    got = port.state_dict()
    torch.testing.assert_close(got["transformer.layers.2.attn.to_q.weight"],
                               arrays[".transformer.layers[2][1].to_q.weight"].float().t())
    torch.testing.assert_close(got["semantic_embedding"], arrays[".semantic_embedding"].float())


def test_cross_attention_slots_are_refused():
    with pytest.raises(KeyError, match="cross attention"):
        state_dict_from_jax({".transformer.layers[0][3].to_q.weight": np.zeros((2, 2))})
