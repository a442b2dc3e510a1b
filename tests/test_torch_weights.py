"""The port's weight bridge and checkpoint loaders: its numpy-only `.npz`
reader against the JAX package's `load_checkpoint`, `state_dict_from_jax`
covering every JAX leaf of the flagship model and of the three r5 LMs, and
the loaders' config rule: a checkpoint saved by JAX loads and computes what
JAX computes (without the value residual too), and a config key the port
does not honour raises."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine
from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
from audiolm_pytorch_tpu.training.checkpoint import load_checkpoint, save_checkpoint

from audiolm_pytorch_tpu_torch import (CoarseTransformer, FineTransformer,
                                       SemanticTransformer, load_coarse_transformer,
                                       load_fine_transformer, load_semantic_transformer,
                                       read_npz, state_dict_from_jax)

from torch_port_util import jax_named

PERSIST = Path(__file__).resolve().parents[1] / "persist"
R5 = PERSIST / "semantic_r5.npz"
FLAGSHIP = dict(dim=1024, depth=6, heads=8, num_semantic_tokens=500)  # __graft_entry__.entry()
# (JAX class, port class, port loader) of each LM
LMS = {"semantic": (JSemantic, SemanticTransformer, load_semantic_transformer),
       "coarse": (JCoarse, CoarseTransformer, load_coarse_transformer),
       "fine": (JFine, FineTransformer, load_fine_transformer)}


def _jax_shapes(cls=JSemantic, **cfg):
    """{key path: shape} of a JAX LM, without computing it."""
    tree = jax.eval_shape(lambda: cls(**cfg, key=jax.random.PRNGKey(0)))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): x.shape for p, x in flat}


def _port_config(cfg):
    keys = ("dim", "depth", "heads", "num_semantic_tokens", "dim_head", "num_residual_streams",
            "codebook_size", "num_coarse_quantizers", "num_fine_quantizers")
    return {k: cfg[k] for k in keys if k in cfg}


@pytest.mark.parametrize("which", ["flagship", "semantic_r5", "coarse_r5", "fine_r5"])
def test_state_dict_covers_every_jax_leaf(which):
    kind = "semantic" if which == "flagship" else which[:-3]
    jcls, pcls, _ = LMS[kind]
    cfg = FLAGSHIP if which == "flagship" else read_npz(PERSIST / f"{which}.npz")[0]["config"]
    shapes = _jax_shapes(jcls, **cfg)
    mapped = state_dict_from_jax({k: torch.empty(s, device="meta") for k, s in shapes.items()})
    port = pcls(**_port_config(cfg), device="cpu").state_dict()
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
    """The cross-attention slots map to the port's names (the port has them
    since it conditions on text); a slot a JAX layer tuple does not have is
    refused."""
    mapped = state_dict_from_jax({".transformer.layers[0][3].null_kv": np.zeros((2, 1, 4)),
                                  ".transformer.layers[1][2].beta": np.zeros(4)})
    assert set(mapped) == {"transformer.layers.0.cross.null_kv", "transformer.layers.1.hc_cross.beta"}
    with pytest.raises(KeyError, match="slot 6"):
        state_dict_from_jax({".transformer.layers[0][6].to_q.weight": np.zeros((2, 2))})


def _small_jax(kind, **kw):
    base = dict(dim=64, depth=2, heads=2, num_residual_streams=1)
    extra = {"semantic": dict(num_semantic_tokens=20),
             "coarse": dict(num_semantic_tokens=20, codebook_size=16, num_coarse_quantizers=3),
             "fine": dict(codebook_size=16, num_coarse_quantizers=3, num_fine_quantizers=5)}
    return LMS[kind][0](**base, **extra[kind], **kw, key=jax.random.PRNGKey(4))


def _logits(kind, model, rng):
    """The LM's logits on seeded ids, from JAX (a jnp model) or the port."""
    is_jax = not isinstance(model, torch.nn.Module)
    conv = jnp.asarray if is_jax else torch.from_numpy
    if kind == "semantic":
        ids = conv(rng.integers(0, 20, size=(2, 17)))
        out = (model(ids=ids),) if is_jax else (model(ids),)
    elif kind == "coarse":
        sem, coarse = conv(rng.integers(0, 20, size=(2, 9))), conv(rng.integers(0, 16, size=(2, 12)))
        out = model(semantic_token_ids=sem, coarse_token_ids=coarse) if is_jax else model(sem, coarse)
    else:
        coarse, fine = conv(rng.integers(0, 16, size=(2, 9))), conv(rng.integers(0, 16, size=(2, 15)))
        out = model(coarse, fine)
    return [np.asarray(o) if is_jax else o.detach().numpy() for o in out]


@pytest.mark.parametrize("kind", ["semantic", "coarse", "fine"])
def test_checkpoint_without_value_residual_loads_and_matches_jax(kind, tmp_path):
    jm = _small_jax(kind, add_value_residual=False)
    path = tmp_path / f"{kind}.npz"
    save_checkpoint(path, jm, config=dict(jm.configs))
    pm = LMS[kind][2](path, device="cpu")
    assert pm.transformer.add_value_residual is False
    for a, r in zip(_logits(kind, pm, np.random.default_rng(5)),
                    _logits(kind, jm, np.random.default_rng(5))):
        np.testing.assert_allclose(a, r, rtol=2e-3, atol=2e-3)


# config keys the port does not honour: a context width other than the
# model's, and a key it does not know (a checkpoint of a conditioned LM loads:
# tests/test_torch_conditioning.py). Dropout, once refused here, is honoured
# now: its cases load and carry the rate.
@pytest.mark.parametrize("key,value", [("attn_dropout", 0.1), ("ff_dropout", 0.1),
                                       ("dim_context", 32), ("something_new", 1)])
@pytest.mark.parametrize("kind", ["semantic", "coarse", "fine"])
def test_unhonoured_config_key_raises(kind, key, value, tmp_path):
    jm = _small_jax(kind)
    path = tmp_path / f"{kind}.npz"
    save_checkpoint(path, jm, config=dict(jm.configs, **{key: value}))
    if key in ("attn_dropout", "ff_dropout"):
        layer = LMS[kind][2](path, device="cpu").transformer.layers[0]
        assert (layer.attn.dropout if key == "attn_dropout" else layer.ff_dropout) == value
    else:
        with pytest.raises(NotImplementedError):
            LMS[kind][2](path, device="cpu")
    # the keys that cannot change the computation pass
    save_checkpoint(path, jm, config=dict(jm.configs, flash_attn=True, cond_drop_prob=0.3))
    LMS[kind][2](path, device="cpu")
