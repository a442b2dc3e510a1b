"""The port's HubertWithKmeans against the JAX package's on the CPU: the
layer-`output_layer` features within 2e-3 (max abs difference over max
abs feature) and the semantic ids equal but for near ties (a frame whose
ids differ must have its two centres within 1e-4 of the distance scale,
|f|^2 + |c|^2, of each other), at the JAX tests' size (dim 48, one layer)
and at the stage recipe's width (dim 256, 3 layers, 4 heads, output layer
3, the corpus centres `results_quality/audiolm_r5/kmeans.npy`), with the
JAX weights carried by `hubert_state_dict_from_jax`; and a synthetic
fairseq-layout checkpoint loaded into both packages."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models.hubert import HubertWithKmeans as JHubert

from audiolm_pytorch_tpu_torch import HubertWithKmeans, hubert_state_dict_from_jax
from test_weight_conversion import make_fairseq_hubert_sd
from torch_port_util import jax_named

REPO = Path(__file__).resolve().parents[1]
KMEANS = REPO / "results_quality" / "audiolm_r5" / "kmeans.npy"
FEAT_TOL = 2e-3
TIE_TOL = 1e-4
TINY = dict(dim=48, num_layers=1, heads=4, output_layer=1, codebook_size=20)
STAGE = dict(dim=256, num_layers=3, heads=4, output_layer=3, codebook_size=100,
             seq_len_multiple_of=320)


def _pair(cfg, seed=0):
    jm = JHubert(**cfg, key=jax.random.PRNGKey(seed))
    pm = HubertWithKmeans(**cfg, device="cpu")
    pm.load_state_dict(hubert_state_dict_from_jax(jax_named(jm)))
    return jm, pm


def _wave(seed, b=2, t=16000):
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / 16000.0
    f0 = rng.uniform(120, 300, size=(b, 1))
    wav = 0.3 * np.sin(2 * np.pi * f0 * tt) + 0.05 * rng.standard_normal((b, t))
    return wav.astype(np.float32)


def _check_ids(ids, ref, feats, centers):
    """ids equal to ref but where the two centres are a near tie."""
    ids, ref = np.asarray(ids), np.asarray(ref)
    assert ids.shape == ref.shape
    f = np.asarray(feats, np.float64).reshape(-1, centers.shape[1])
    c = np.asarray(centers, np.float64)
    d = (f ** 2).sum(-1, keepdims=True) - 2 * f @ c.T + (c ** 2).sum(-1)
    scale = (f ** 2).sum(-1) + (c ** 2).sum(-1).max()
    rows = np.arange(len(f))
    gap = np.abs(d[rows, ids.reshape(-1)] - d[rows, ref.reshape(-1)]) / scale
    assert gap.max() <= TIE_TOL, f"ids differ beyond a near tie: {gap.max():.2e}"
    return int((ids != ref).sum())


def _compare(jm, pm, wav, output_layer):
    """Features of the wave as the tokenizer curtails it, then the ids of
    the whole wave."""
    mult = pm.seq_len_multiple_of or 1
    cut = wav[:, : wav.shape[1] // mult * mult]
    feats_j = np.asarray(jax.jit(lambda m, w: m.encoder.extract_features(w, output_layer))(
        jm, jnp.asarray(cut)))
    feats_p = pm.encoder.extract_features(torch.from_numpy(cut), output_layer).detach().numpy()
    err = np.abs(feats_p - feats_j).max() / np.abs(feats_j).max()
    assert err < FEAT_TOL, err
    ids_j = np.asarray(jax.jit(lambda m, w: m(w))(jm, jnp.asarray(wav)))
    ids_p = pm(torch.from_numpy(wav)).numpy()
    _check_ids(ids_p, ids_j, feats_p, pm.cluster_centers.numpy())
    return feats_p, ids_p


@pytest.mark.parametrize("seed", [0, 1])
def test_features_and_ids_at_jax_test_size(seed):
    jm, pm = _pair(TINY, seed)
    _compare(jm, pm, _wave(seed, t=3200), TINY["output_layer"])


def test_stage_width_with_corpus_kmeans():
    jm, pm = _pair(STAGE, seed=1)
    jm.load_kmeans(KMEANS)
    pm.load_kmeans(KMEANS)
    np.testing.assert_array_equal(pm.cluster_centers.numpy(), np.load(KMEANS))
    assert pm.codebook_size == 100 and pm.downsample_factor == 320
    wav = _wave(3, b=2, t=16000 * 3 + 123)  # curtailed to a multiple of 320
    feats, ids = _compare(jm, pm, wav, STAGE["output_layer"])
    assert ids.shape == (2, 149) and ids.dtype == np.int64  # 3 s: 149 frames


def test_fairseq_checkpoint_loads_into_both(tmp_path):
    sd = make_fairseq_hubert_sd()
    path = tmp_path / "hubert.pt"
    torch.save({"model": sd}, path)
    cfg = dict(dim=48, num_layers=2, heads=4, output_layer=2, ff_dim=96, codebook_size=16)
    jm = JHubert(str(path), **cfg, key=jax.random.PRNGKey(0))
    pm = HubertWithKmeans(str(path), **cfg, device="cpu")
    assert pm.pretrained
    for name, a in hubert_state_dict_from_jax(jax_named(jm)).items():
        if name != "cluster_centers":
            np.testing.assert_allclose(pm.state_dict()[name].numpy(), a.numpy(), rtol=1e-6,
                                       err_msg=name)
    centers = np.random.default_rng(2).standard_normal((16, 48)).astype(np.float32)
    np.save(tmp_path / "km.npy", centers)
    jm.load_kmeans(tmp_path / "km.npy")
    pm.load_kmeans(tmp_path / "km.npy")
    _compare(jm, pm, _wave(4, t=3200), 2)


def test_frozen_and_unported_rate_raises():
    pm = HubertWithKmeans(**TINY, device="cpu")
    assert not any(p.requires_grad for p in pm.parameters())
    # another input rate is resampled to 16 kHz first (ops/resample.py)
    assert pm(torch.zeros(1, 4800), input_sample_hz=24000).shape == (1, 9)
    assert pm(torch.zeros(1, 3200), input_sample_hz=16000).shape == (1, 9)
