"""Heads wider than 128 through the port's models against the JAX package on
the CPU, with the weights carried across: a Semantic LM with two heads of
256 (its loss and every parameter gradient under one forgetful mask, as
tests/test_torch_train.py holds the 64-wide model), and the codec's
attention at `attn_dim_head` 256: LocalMHA's output and its input and
parameter gradients, and a tiny codec's frames, codes and decode. On the
card these heads run the kernels' column-sliced form; here the plain
versions, which the card's kernels are held to.

Tolerances: as tests/test_torch_train.py (2e-3 on the loss, rtol 1e-2 /
atol 1e-3 on gradients), tests/test_torch_local_attention.py (2e-3 on
LocalMHA's output) and tests/test_torch_codec.py (1e-4 on the codec, codes
identical)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
from audiolm_pytorch_tpu.ops import attention as ja

from audiolm_pytorch_tpu_torch import SemanticTransformer, SemanticTransformerWrapper, SoundStream
from audiolm_pytorch_tpu_torch.ops import attention as pa
from audiolm_pytorch_tpu_torch.weights import codec_state_dict_from_jax, state_dict_from_jax

from test_torch_codec import TINY, TINY_TOL, _random_weights, pallas_vq  # noqa: F401
from test_torch_train import _inject_masks, _jax_loss_and_grads, _masks
from tests.test_soundstream import tiny_soundstream
from torch_port_util import jax_named, jax_replace, load_into, t

GRAD_TOL = dict(rtol=1e-2, atol=1e-3)
TOL = dict(rtol=2e-3, atol=2e-3)
WIDE_LM = dict(dim=64, depth=1, heads=2, dim_head=256, num_semantic_tokens=32)


def test_semantic_lm_with_256_wide_heads_matches_jax(monkeypatch):
    jm = JSemantic(**WIDE_LM, key=jax.random.PRNGKey(3))
    pm = load_into(SemanticTransformer(**WIDE_LM, device="cpu"), jm)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 32, size=(2, 40))
    ids[1, 33:] = -1
    mask, = _masks(rng, 1, 2, 40)
    _inject_masks(monkeypatch, [mask])
    loss_ref, grads_ref = _jax_loss_and_grads(jm, ids, mask)
    loss = SemanticTransformerWrapper(transformer=pm)(torch.from_numpy(ids), return_loss=True,
                                                      train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=2e-3, atol=2e-3)
    ref = state_dict_from_jax(jax_named(grads_ref))
    named = dict(pm.named_parameters())
    assert set(ref) == set(named)
    assert named["transformer.layers.0.attn.to_q.weight"].shape[0] == 2 * 256
    for name, g in ref.items():
        p = named[name]
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), g.numpy(), **GRAD_TOL, err_msg=name)


def test_local_mha_with_256_wide_heads_and_its_gradients_match_jax():
    rng = np.random.default_rng(4)
    jm = ja.LocalMHA(dim=32, heads=2, dim_head=256, window_size=16, key=jax.random.PRNGKey(4))
    named = jax_named(jm)
    jm = jax_replace(jm, {k: rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
                          for k, a in named.items() if k.endswith(("q_scale", "k_scale"))})
    pm = pa.LocalMHA(dim=32, heads=2, dim_head=256, window_size=16)
    pm.load_state_dict(codec_state_dict_from_jax(jax_named(jm)))
    x = rng.normal(size=(2, 50, 32)).astype(np.float32)
    mask = np.ones((2, 50), bool)
    mask[1, 30:] = False
    g = rng.normal(size=(2, 50, 32)).astype(np.float32)

    def jloss(mod, a):
        out = mod(a, mask=jnp.asarray(mask))
        return (out * jnp.asarray(g)).sum(), out

    (_, want), (jgrad_m, jgrad_x) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                               has_aux=True))(jm, jnp.asarray(x))
    xt = t(x).requires_grad_()
    out = pm(xt, mask=t(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    (out * t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad_x), **GRAD_TOL)
    ref = codec_state_dict_from_jax(jax_named(jgrad_m))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), **GRAD_TOL, err_msg=name)


def test_tiny_codec_with_256_wide_heads_matches_jax(pallas_vq):
    """tests/test_torch_codec.py's tiny codec with attn_dim_head 256: its
    frames, codes (identical) and decode."""
    rng = np.random.default_rng(5)
    shapes = jax.eval_shape(lambda: tiny_soundstream(key=jax.random.PRNGKey(5),
                                                     attn_dim_head=256))
    new = _random_weights(shapes, rng)
    pm = SoundStream(**dict(TINY, attn_dim_head=256), device="cpu").eval()
    pm.load_state_dict(codec_state_dict_from_jax(new))
    with torch.no_grad():
        h = pm.encode_frames(t(rng.normal(size=(2, 512)).astype(np.float32))).numpy()
    for name, a in new.items():
        if name.endswith("codebook[<flat index 0>]"):
            q = int(name.split(".layers[")[1].split("]")[0])
            new[name] = (h.std() * 0.5 ** q * rng.normal(size=a.shape)).astype(np.float32)
    pm.load_state_dict(codec_state_dict_from_jax(new))
    jm = jax_replace(shapes, new)
    x = rng.normal(size=(2, 1030)).astype(np.float32) * 0.5

    def serving(m, a):
        codes = m.tokenize(a)
        return dict(frames=m.encode_frames(m.process_input(a)), codes=codes,
                    wave=m.decode_from_codebook_indices(codes))

    want = jax.jit(serving)(jm, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(pm.encode_frames(pm.process_input(t(x))).numpy(),
                                   np.asarray(want["frames"]), **TINY_TOL)
        codes = pm.tokenize(t(x))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(want["codes"]))
        np.testing.assert_allclose(pm.decode_from_codebook_indices(codes).numpy(),
                                   np.asarray(want["wave"]), **TINY_TOL)
