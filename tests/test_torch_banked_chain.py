"""AudioLM's unprompted greedy chain on the banked stages against the JAX
package on the CPU: persist/{semantic,coarse,fine}_r5.npz with the codec
they are token-paired to, persist/soundstream_r5.npz, at temperature -> 0;
the semantic ids and the coarse and fine codes identical, the waveform
within 1e-4 (float32, summation order only)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine

from audiolm_pytorch_tpu_torch import AudioLM

from test_torch_audiolm import _assert_waves, _Compiled

REPO = Path(__file__).resolve().parents[1]
BANKED_IDS = 50  # 1 s: 50 semantic ids, at most 50 coarse time steps


def test_banked_chain_is_token_identical_to_jax():
    """AudioLM's unprompted greedy chain (temperature -> 0) on the banked
    stages `persist/{semantic,coarse,fine}_r5.npz` with the codec they are
    token-paired to, `persist/soundstream_r5.npz`: the semantic ids, the
    coarse and the fine codes identical to JAX's wrappers called in turn,
    and the waveform of the port's AudioLM the decode of those codes,
    within 1e-4 of JAX's."""
    from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
    from audiolm_pytorch_tpu.models.soundstream import SoundStream as JSoundStream
    from audiolm_pytorch_tpu.training.checkpoint import load_checkpoint
    from audiolm_pytorch_tpu_torch import (load_coarse_transformer, load_fine_transformer,
                                           load_semantic_transformer, load_soundstream)
    persist = REPO / "persist"
    jm = {}
    for kind, cls in (("semantic", JSemantic), ("coarse", JCoarse), ("fine", JFine)):
        ckpt = load_checkpoint(persist / f"{kind}_r5.npz")
        jm[kind] = ckpt["restore"](cls(**ckpt["config"], key=jax.random.PRNGKey(0)))
    ckpt = load_checkpoint(persist / "soundstream_r5.npz")
    cfg = {k: tuple(v) if isinstance(v, list) else v for k, v in ckpt["config"].items()}
    shapes = jax.eval_shape(lambda: JSoundStream(**cfg, key=jax.random.PRNGKey(0)))
    jcodec = _Compiled(ckpt["restore"](shapes))
    codec = load_soundstream(persist / "soundstream_r5.npz", device="cpu", discriminators=False)
    semantic = load_semantic_transformer(persist / "semantic_r5.npz", device="cpu")
    coarse = load_coarse_transformer(persist / "coarse_r5.npz", device="cpu")
    fine = load_fine_transformer(persist / "fine_r5.npz", device="cpu")
    kw = dict(temperature=1e-10)
    sem_j = jw.SemanticTransformerWrapper(transformer=jm["semantic"]).generate(
        batch_size=1, max_length=BANKED_IDS, **kw)
    co_j = jw.CoarseTransformerWrapper(transformer=jm["coarse"], codec=jcodec).generate(
        semantic_token_ids=sem_j, max_time_steps=BANKED_IDS, **kw)
    fi_j = jw.FineTransformerWrapper(transformer=jm["fine"], codec=jcodec).generate(
        coarse_token_ids=co_j, **kw)
    audiolm = AudioLM(codec=codec, semantic_transformer=semantic, coarse_transformer=coarse,
                      fine_transformer=fine)
    g = torch.Generator().manual_seed(0)
    sem = audiolm.semantic.generate(batch_size=1, max_length=BANKED_IDS, generator=g, **kw)
    co = audiolm.coarse.generate(semantic_token_ids=sem, max_time_steps=BANKED_IDS,
                                 generator=g, **kw)
    fi = audiolm.fine.generate(coarse_token_ids=co, generator=g, **kw)
    np.testing.assert_array_equal(sem.numpy(), np.asarray(sem_j))
    np.testing.assert_array_equal(co.numpy(), np.asarray(co_j))
    np.testing.assert_array_equal(fi.numpy(), np.asarray(fi_j))
    assert (sem >= 0).sum() > 10 and (co >= 0).all(-1).sum() > 10  # not an empty chain
    wave = audiolm(batch_size=1, max_length=BANKED_IDS, max_coarse_time_steps=BANKED_IDS,
                   generator=torch.Generator().manual_seed(0), **kw)
    both = np.concatenate([np.asarray(co_j), np.asarray(fi_j)], -1)
    want = jw.decode_acoustic_tokens(jcodec, jnp.asarray(both), pad_id=-1)
    _assert_waves(wave, want if isinstance(want, list) else np.asarray(want))
