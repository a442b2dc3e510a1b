"""The port's Semantic, Coarse and Fine trainers against the JAX package's on
the CPU: the same folder of WAV clips, the same split and batches, a tiny
HuBERT + k-means tokenizer and a tiny codec with the same weights, and the
same forgetful masks (fixed by their shape on both sides).

Per trainer, in float32 (bf16 compute: tests/test_torch_lm_trainers_bf16.py):
two `train_step`s, each
step's loss against JAX's (2e-3 in float32, 3e-2 in bf16); the first
step's accumulated, clipped gradient against JAX's gradient of the same
micro-batches (float32: rtol 1e-2 / atol 1e-3, the JAX package's gradient
tolerance; bf16: the relative norm of the whole gradient within 5e-2, see
tests/test_torch_bf16.py); the valid loss at step 2 (float32 weights in
both modes, 2e-3) and the best-valid checkpoint it writes. Then the
model leaf names against the persisted chain
`persist/{semantic,coarse,fine}_r5.npz`, and the options that raise. The
checkpoints both ways and resumption: tests/test_torch_lm_checkpoints.py."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import lm as jlm
from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.hubert import HubertWithKmeans as JHubert
from audiolm_pytorch_tpu.nn.module import cast_floats, combine, partition_trainable_where
from audiolm_pytorch_tpu.training import trainer as jtrainer
from audiolm_pytorch_tpu.utils import audio_io as jaudio

from audiolm_pytorch_tpu_torch import (CoarseTransformer, CoarseTransformerTrainer,
                                       FineTransformer, FineTransformerTrainer, HubertWithKmeans,
                                       SemanticTransformer, SemanticTransformerTrainer,
                                       hubert_state_dict_from_jax, load_coarse_transformer,
                                       load_fine_transformer, load_semantic_transformer)
from audiolm_pytorch_tpu_torch.models import wrappers as pw
from audiolm_pytorch_tpu_torch.weights import state_dict_from_jax

from test_torch_bf16 import _mask_for
from test_torch_codec_train import _tiny_pair
from torch_port_util import jax_named, load_into

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
FWD = 2e-3
BF16_TOL = 3e-2
GRAD = dict(rtol=1e-2, atol=1e-3)
GRAD_BF16_TOL = 5e-2
CLIP = 3200  # samples: 9 HuBERT frames, 400 codec frames
LM = dict(dim=64, depth=1, heads=2, dim_head=64, num_residual_streams=1)
W2V = dict(dim=48, num_layers=1, heads=4, output_layer=1, codebook_size=20,
           seq_len_multiple_of=320)
KINDS = ("semantic", "coarse", "fine")


@pytest.fixture(scope="module")
def clip_folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(0)
    tt = np.arange(CLIP) / 16000.0
    for i in range(8):
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 600) * tt) \
            + 0.05 * rng.standard_normal(CLIP)
        jaudio.save_audio(folder / f"clip_{i}.wav", wav.astype(np.float32), 16000)
    return folder


@pytest.fixture
def same_masks(monkeypatch):
    monkeypatch.setattr(pw, "generate_mask_with_prob", lambda shape, p, *, generator=None,
                        device=None: torch.from_numpy(_mask_for(tuple(shape))).to(device))
    monkeypatch.setattr(jw, "generate_mask_with_prob",
                        lambda key, shape, p: jnp.asarray(_mask_for(tuple(shape))))


def _models(kind, seed=0):
    """(JAX transformer, port transformer, JAX and port trainer kwargs of
    the frozen tokenizers)."""
    key = jax.random.PRNGKey(seed)
    jw2v = JHubert(**W2V, key=jax.random.PRNGKey(seed + 1))
    pw2v = HubertWithKmeans(**W2V, device="cpu")
    pw2v.load_state_dict(hubert_state_dict_from_jax(jax_named(jw2v)))
    jcodec, pcodec = _tiny_pair(seed=seed + 2, codebook_scale=0.5)
    q = jcodec.rq_num_quantizers if hasattr(jcodec, "rq_num_quantizers") else 4
    if kind == "semantic":
        cfg = dict(LM, num_semantic_tokens=20)
        return (jlm.SemanticTransformer(**cfg, key=key), SemanticTransformer(**cfg, device="cpu"),
                dict(wav2vec=jw2v), dict(wav2vec=pw2v))
    if kind == "coarse":
        cfg = dict(LM, num_semantic_tokens=20, codebook_size=64, num_coarse_quantizers=2)
        return (jlm.CoarseTransformer(**cfg, key=key), CoarseTransformer(**cfg, device="cpu"),
                dict(codec=jcodec, wav2vec=jw2v), dict(codec=pcodec, wav2vec=pw2v))
    cfg = dict(LM, num_coarse_quantizers=2, num_fine_quantizers=q - 2, codebook_size=64)
    return (jlm.FineTransformer(**cfg, key=key), FineTransformer(**cfg, device="cpu"),
            dict(codec=jcodec), dict(codec=pcodec))


_JAX = {"semantic": jtrainer.SemanticTransformerTrainer,
        "coarse": jtrainer.CoarseTransformerTrainer, "fine": jtrainer.FineTransformerTrainer}
_PORT = {"semantic": SemanticTransformerTrainer, "coarse": CoarseTransformerTrainer,
         "fine": FineTransformerTrainer}


def _trainer_pair(kind, folder, tmp_path, seed=0, **kw):
    jm, pm, jfrozen, pfrozen = _models(kind, seed)
    load_into(pm, jm)
    common = dict(folder=str(folder), batch_size=2, grad_accum_every=2, num_train_steps=4,
                  lr=1e-5, warmup_steps=2, data_max_length=CLIP, save_results_every=2,
                  save_model_every=2, valid_frac=0.25)
    common.update(kw)
    jtr = _JAX[kind](jm, **jfrozen, **common, results_folder=str(tmp_path / "jax"),
                     data_parallel=False)
    ptr = _PORT[kind](pm, **pfrozen, **common, results_folder=tmp_path / "port", device="cpu")
    return jtr, ptr


def _close(*trainers):
    for tr in trainers:
        tr.dl_iter.stop()
        tr.valid_dl_iter.stop()


def _jax_grads(jtr, micro_batches, bf16):
    """JAX's gradient of the mean loss of the micro-batches, clipped as its
    chain clips it, as the port's state_dict."""
    params, rest = partition_trainable_where(jtr.wrapper, lambda p: not jtrainer._frozen_path(p))

    def loss(p, batch):
        p = cast_floats(p, jnp.bfloat16) if bf16 else p
        return combine(p, rest)(**batch, return_loss=True, train=True,
                                key=jax.random.PRNGKey(0))

    grad = jax.jit(jax.grad(loss))
    total = None
    for batch in micro_batches:
        g = jax_named(grad(params, {k: jnp.asarray(v) for k, v in batch.items()}))
        total = g if total is None else {k: total[k] + g[k] for k in g}
    grads = {k[len(".transformer"):]: v / len(micro_batches) for k, v in total.items()}
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in grads.values()))
    if norm >= 0.5:
        grads = {k: v * (0.5 / norm) for k, v in grads.items()}
    return state_dict_from_jax(grads)


def check_trainer_steps(kind, bf16, clip_folder, tmp_path):
    """Two steps of the port's trainer against the JAX trainer's."""
    jtr, ptr = _trainer_pair(kind, clip_folder, tmp_path, bf16_compute=bf16)
    seen = []
    step = ptr.step_fn.step

    def recording_step(**named):
        seen.append({k: v.numpy().copy() for k, v in named.items()})
        return step(**named)

    ptr.step_fn.step = recording_step
    try:
        tol = BF16_TOL if bf16 else FWD
        for i in range(2):
            jparams = jtr.wrapper if i == 0 else None
            jlogs = jtr.train_step()
            plogs = ptr.train_step()
            np.testing.assert_allclose(plogs["loss"], jlogs["loss"], rtol=tol, err_msg=str(i))
            if i == 0:
                # the first step's gradient: the port's accumulated, clipped .grad
                batch = seen[0]
                accum = ptr.grad_accum_every
                micro = [{k: v.reshape(accum, -1, *v.shape[1:])[j] for k, v in batch.items()}
                         for j in range(accum)]
                jtr_before = type("W", (), {"wrapper": jparams})
                want = _jax_grads(jtr_before, micro, bf16)
                got = {n: p.grad for n, p in zip(ptr.step_fn.names, ptr.step_fn.params)}
                assert set(got) == set(want)
                if bf16:
                    num = sum(float((got[n] - w).square().sum()) for n, w in want.items())
                    den = sum(float(w.square().sum()) for w in want.values())
                    assert (num / den) ** 0.5 <= GRAD_BF16_TOL
                else:
                    for n, w in want.items():
                        np.testing.assert_allclose(got[n].numpy(), w.numpy(), **GRAD, err_msg=n)
        # step 2 evaluates and writes the best checkpoint on both sides
        np.testing.assert_allclose(plogs["valid_loss"], jlogs["valid_loss"], rtol=FWD)
        assert ptr.best_valid == plogs["valid_loss"]
        for folder in (tmp_path / "jax", tmp_path / "port"):
            assert sorted(p.name for p in folder.glob("*.ckpt.npz")) == \
                [f"{kind}.transformer.2.ckpt.npz", f"{kind}.transformer.best.ckpt.npz"]
        assert all(p.dtype == torch.float32 for p in ptr.wrapper.transformer.parameters())
    finally:
        _close(jtr, ptr)


@pytest.mark.parametrize("kind", KINDS)
def test_trainer_steps_match_jax(kind, clip_folder, tmp_path, same_masks):
    check_trainer_steps(kind, False, clip_folder, tmp_path)


class _Waves:
    def __init__(self, n=4, fields=1):
        rng = np.random.default_rng(3)
        self.items = [tuple(rng.standard_normal(CLIP).astype(np.float32) * 0.1
                            for _ in range(fields)) for _ in range(n)]
        self.fields = fields

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i] if self.fields > 1 else self.items[i][0]


@pytest.mark.parametrize("kind,loader", [("semantic", load_semantic_transformer),
                                         ("coarse", load_coarse_transformer),
                                         ("fine", load_fine_transformer)])
def test_saved_leaf_names_are_the_persisted_chains(kind, loader, tmp_path):
    path = REPO / "persist" / f"{kind}_r5.npz"
    model = loader(path, device="cpu")
    fields = 2 if kind == "coarse" else 1
    ptr = _PORT[kind](model, dataset=_Waves(fields=fields), batch_size=2, num_train_steps=1,
                      results_folder=tmp_path, device="cpu")
    try:
        ptr.save(tmp_path / "x.ckpt.npz")
    finally:
        ptr.close()
    with np.load(path) as data:
        persisted = json.loads(bytes(data["__meta__"].tobytes()))
    with np.load(tmp_path / "x.ckpt.npz") as data:
        saved = json.loads(bytes(data["__meta__"].tobytes()))
    names = [n[len("['model']"):] for n in saved["leaf_names"] if n.startswith("['model']")]
    assert sorted(names) == sorted(persisted["leaf_names"])
    assert saved["config"] == persisted["config"]


def test_text_fields_raise_and_generate_runs(tmp_path):
    model = SemanticTransformer(**LM, num_semantic_tokens=20, device="cpu")
    ptr = SemanticTransformerTrainer(model, dataset=_Waves(), batch_size=2, num_train_steps=1,
                                     results_folder=tmp_path, device="cpu")
    try:
        # a field of strings becomes the T5 embeddings of the whole list
        cond = SemanticTransformerTrainer(
            SemanticTransformer(**LM, num_semantic_tokens=20, has_condition=True,
                                t5_name="google/t5-v1_1-small", device="cpu"),
            dataset=_Waves(), batch_size=2, num_train_steps=1, results_folder=tmp_path,
            device="cpu")
        try:
            kwargs = cond._batch_to_kwargs((np.zeros((2, CLIP), np.float32), ["a", "b c"]))
        finally:
            cond.close()
        assert set(kwargs) == {"raw_wave", "text_embeds"}
        assert kwargs["text_embeds"].shape == (2, 3, 512)
        ids = ptr.generate(max_length=8, batch_size=2)
        assert ids.shape == (2, 8)
    finally:
        ptr.close()
    with pytest.raises(ValueError, match="codebook size"):
        SemanticTransformerTrainer(SemanticTransformer(**LM, num_semantic_tokens=21,
                                                       device="cpu"),
                                   HubertWithKmeans(**W2V, device="cpu"), dataset=_Waves(),
                                   batch_size=2, num_train_steps=1, results_folder=tmp_path,
                                   device="cpu")
