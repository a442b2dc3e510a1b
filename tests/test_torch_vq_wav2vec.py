"""The port's vq-wav2vec tokenizer (`FairseqVQWav2Vec`) against the JAX
package on the CPU, on tests/test_weight_conversion.py's small spec (three
convolutions, 8 channels, 12 codewords in 2 groups): the features and the
ids, flattened and not, plain and with combine_groups, skip connections and
log compression together; the fairseq-layout checkpoint of
`make_torch_vqw2v` read through the pickle gate and refused without
allow_pickle, its ids the replica's; the released spec's shape.

The JAX model is built from its shapes (`jax.eval_shape`) and given random
weights (numpy, seeded), carried to the port by
`weights.vq_wav2vec_state_dict_from_jax`. Tolerances: features 1e-5; ids
equal."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models.vq_wav2vec import FairseqVQWav2Vec as JVQ

from audiolm_pytorch_tpu_torch import FairseqVQWav2Vec, vq_wav2vec_state_dict_from_jax

from test_weight_conversion import make_torch_vqw2v
from torch_port_util import jax_replace, t

SPEC = ((8, 10, 5), (8, 4, 2), (8, 1, 1))
SMALL = dict(conv_spec=SPEC, codebook_size=12, num_groups=2)
OPTIONS = {"plain": {},
           "combine_skip_log": dict(combine_groups=True, skip_connections=True,
                                    log_compression=True)}


def vq_pair(seed=0, **kw):
    """A JAX FairseqVQWav2Vec built by shape with random weights, and the
    port's copy of it."""
    kw = dict(SMALL, **kw)
    shapes = jax.eval_shape(lambda k: JVQ(**kw, key=k), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    new = {}
    for path, a in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = jax.tree_util.keystr(path)
        if name.endswith("norm_weight"):
            v = rng.uniform(0.5, 1.5, size=a.shape)
        elif name.endswith("norm_bias"):
            v = 0.1 * rng.normal(size=a.shape)
        elif name.endswith("embedding"):
            v = 0.5 * rng.normal(size=a.shape)
        else:
            v = rng.uniform(-1, 1, size=a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        new[name] = v.astype(np.float32)
    jm = jax_replace(shapes, new)
    pm = FairseqVQWav2Vec(**kw, device="cpu")
    pm.load_state_dict(vq_wav2vec_state_dict_from_jax(new))
    return jm, pm


@pytest.mark.parametrize("option", list(OPTIONS))
def test_features_and_ids_match_jax(option):
    jm, pm = vq_pair(seed=1, **OPTIONS[option])
    wave = np.random.default_rng(2).normal(size=(2, 2003)).astype(np.float32)
    jfeat, jids, jflat = jax.jit(lambda m, w: (m._features(w), m(w, flatten=False), m(w)))(
        jm, jnp.asarray(wave))
    with torch.no_grad():
        feat = pm._features(t(wave))
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), rtol=1e-5, atol=1e-5)
    ids = pm(t(wave), flatten=False)
    assert ids.shape == (2, 198, 2) and pm.downsample_factor == 10
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert len(np.unique(np.asarray(jids))) > 4
    np.testing.assert_array_equal(pm(t(wave)).numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(pm(t(wave)).numpy(), ids.numpy().reshape(2, -1))


def test_fairseq_checkpoint_through_the_pickle_gate(tmp_path):
    """fairseq stores its args as a pickled Namespace: the port loads such a
    file only with allow_pickle=True, re-configures from the args (the
    model it was built as is replaced), and then gives the fairseq-layout
    replica's ids; a weights-only file loads without the gate."""
    ref = make_torch_vqw2v(spec=SPEC)
    args = argparse.Namespace(conv_feature_layers=str(list(SPEC)), vq_vars=12, vq_groups=2,
                              log_compression=False, skip_connections_feat=False,
                              residual_scale=0.5)
    path = tmp_path / "vq_wav2vec_kmeans.pt"
    torch.save({"args": args, "model": ref.state_dict()}, path)
    with pytest.raises(RuntimeError, match="allow_pickle"):
        FairseqVQWav2Vec(path, device="cpu")
    pm = FairseqVQWav2Vec(path, allow_pickle=True, conv_spec=_VQ_DEFAULT_SPEC, device="cpu")
    assert pm.pretrained and pm.conv_spec == SPEC and pm.codebook_size == 12 and pm.groups == 2
    wave = np.random.default_rng(3).normal(size=(2, 500)).astype(np.float32)
    with torch.no_grad():
        _, want = ref(t(wave))
    got = pm(t(wave), flatten=False)
    assert len(np.unique(want.numpy())) > 6
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    weights_only = tmp_path / "weights_only.pt"
    torch.save({"model": ref.state_dict()}, weights_only)
    again = FairseqVQWav2Vec(weights_only, conv_spec=SPEC, codebook_size=12, device="cpu")
    np.testing.assert_array_equal(again(t(wave), flatten=False).numpy(), want.numpy())


_VQ_DEFAULT_SPEC = ((512, 10, 5), (512, 8, 4))  # rebuilt from the checkpoint's args


def test_released_spec():
    """The released encoder's shape: 160 samples a frame (the reference
    says 80), 320 codewords in 2 groups, ids (B, frames * 2) flattened."""
    pm = FairseqVQWav2Vec(device="cpu")
    assert pm.downsample_factor == 160 and pm.codebook_size == 320 and pm.groups == 2
    assert [b.weight.shape[0] for b in pm.encoder] == [512] * 8
    n = 24000 + 17
    frames = n
    for _, k, stride in pm.conv_spec:
        frames = (frames - k) // stride + 1
    ids = pm(torch.zeros(1, n).normal_(generator=torch.Generator().manual_seed(0)))
    assert frames == 148 and ids.shape == (1, 2 * frames) and int(ids.max()) < 320
