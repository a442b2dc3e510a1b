"""The port's SoundStream trainer against the JAX package on the CPU: the
EMA of the model, two trainer steps against the JAX trainer's own step
functions (`_g_step`, `_d_step`), checkpoints read by the other package, the
training loop with its samples and resumption, the loader with and without
the discriminators, the trainer's options and the quantizer without kmeans
init. The random draws and JAX's quantizer on its TPU path as in
tests/test_torch_codec_train.py, whose helpers these tests share.

Tolerances: forward values 2e-3 relative; quantizer state 1e-4 relative;
the trainer's steps as tests/test_torch_train.py compares them (losses
2e-3; each leaf's update by relative norm at lr 1e-5, 5e-2, over the leaves
whose JAX update is over 1e-6 of the largest: Adam turns float32 noise into
updates of +-lr).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.nn.module import partition_trainable_where
from audiolm_pytorch_tpu.training import checkpoint as jckpt
from audiolm_pytorch_tpu.training.ema import ema_init, ema_update
from audiolm_pytorch_tpu.training.trainer import _discr_path

from audiolm_pytorch_tpu_torch import EMA, SoundStream, SoundStreamTrainer, load_soundstream
from audiolm_pytorch_tpu_torch.ops import quantize as pq
from audiolm_pytorch_tpu_torch.training.checkpoint import load_pytree_into
from audiolm_pytorch_tpu_torch.utils import audio_io as paudio
from audiolm_pytorch_tpu_torch.weights import codec_state_dict_from_jax

from test_torch_codec_train import (FWD, STATE, JaxDraws, _Clips, _float_leaves, _port_named,
                                    _random_weights, _tiny_pair, _trainers, _waves,
                                    pallas_vq)  # noqa: F401
from tests.test_soundstream import tiny_soundstream
from tests.test_torch_codec import CKPT, TINY
from torch_port_util import jax_named, jax_replace, t


def test_ema_matches_jax():
    shapes = jax.eval_shape(lambda: tiny_soundstream(key=jax.random.PRNGKey(0)))
    rng = np.random.default_rng(10)
    # the quantizers' `initted` flips between models: a bool tracks the model
    models = [jax_replace(shapes, _random_weights(shapes, rng, 0.5 if i % 2 else None))
              for i in range(6)]
    kw = dict(beta=0.9, update_after_step=2, update_every=2)
    jstate = ema_init(models[0])
    pm = SoundStream(**TINY, device="cpu")
    pm.load_state_dict(codec_state_dict_from_jax(jax_named(models[0])))
    ema = EMA(pm, **kw)
    jupdate = jax.jit(lambda s, m: ema_update(s, m, **kw))
    for m in models[1:]:
        jstate = jupdate(jstate, m)
        pm.load_state_dict(codec_state_dict_from_jax(jax_named(m)))
        ema.update(pm)
    assert ema.step == int(jstate.step) == 5
    want, got = jax_named(jstate.shadow), _port_named(ema.shadow)
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=1e-7, err_msg=name)


def test_trainer_steps_match_the_jax_step_functions(pallas_vq, monkeypatch, tmp_path):
    """Two steps, the first with the gradient penalty: the JAX trainer's
    `_g_step` and `_d_step` against the port's `g_step` and `d_step` on the
    same batches and draws; the losses, each leaf's update, the quantizers'
    state and the EMA shadow."""
    from audiolm_pytorch_tpu.nn.module import combine
    kw = dict(rq_kwargs=dict(threshold_ema_dead_code=0.25))
    jm, pm = _tiny_pair(seed=11, codebook_scale=0.5, **kw)
    jtr, ptr = _trainers(tmp_path, jm, pm)
    draws = JaxDraws(monkeypatch)
    keys = []
    forward = ptr.model.forward

    def drawn_forward(x, **kwargs):
        if kwargs.get("train"):
            draws.codec(keys.pop(0), ptr.model, x.shape[0] * x.shape[1] // 8)
        return forward(x, **kwargs)

    monkeypatch.setattr(ptr.model, "forward", drawn_forward)
    rng = np.random.default_rng(13)
    try:
        for step in range(2):
            waves = np.stack([_waves(rng) for _ in range(2)])  # (accum, B, T)
            kg, kd = jax.random.PRNGKey(200 + step), jax.random.PRNGKey(300 + step)
            apply_gp = step % 2 == 0
            before_j, before_p = jax_named(jtr.model), _port_named(ptr.model)
            gen, rest = partition_trainable_where(jtr.model, lambda p: not _discr_path(p))
            jtr.model, jtr.gen_opt_state, jtr.ema_state, jg, jbd = jtr._g_step(
                gen, rest, jtr.gen_opt_state, jtr.ema_state, jnp.asarray(waves), kg)
            dparams, drest = partition_trainable_where(jtr.model, _discr_path)
            new_d, jtr.discr_opt_state, jd = jtr._d_step[apply_gp](
                dparams, drest, jtr.discr_opt_state, jnp.asarray(waves), kd)
            jtr.model = combine(new_d, drest)
            keys += list(jax.random.split(kg, 2))
            pg, pbd = ptr.g_step(t(waves))
            pd = ptr.d_step(t(waves), apply_gp)
            assert not draws.queue and not keys
            np.testing.assert_allclose(pg.item(), float(jg), **FWD)
            np.testing.assert_allclose(pbd.numpy(), np.asarray(jbd), **FWD)
            np.testing.assert_allclose(pd.item(), float(jd), **FWD)
            after_j, after_p = jax_named(jtr.model), _port_named(ptr.model)
            updates = {k: (after_p[k] - before_p[k], after_j[k] - before_j[k])
                       for k in _float_leaves(after_j) if "[<flat" not in k}
            largest = max(np.linalg.norm(dj) for _, dj in updates.values())
            for name, (dp, dj) in updates.items():
                if np.linalg.norm(dj) > 1e-6 * largest:
                    gap = np.linalg.norm(dp - dj) / np.linalg.norm(dj)
                    assert gap < 5e-2, (step, name, gap)
            for name in after_j:
                if "[<flat" in name:  # the quantizers' state
                    np.testing.assert_allclose(after_p[name], after_j[name], **STATE,
                                               err_msg=name)
            shadow_j, shadow_p = jax_named(jtr.ema_state.shadow), _port_named(ptr.ema.shadow)
            for name, w in _float_leaves(shadow_j).items():
                np.testing.assert_allclose(shadow_p[name], w, rtol=1e-4, atol=1e-6,
                                           err_msg=name)
    finally:
        ptr.close()
        jtr.dl_iter.stop()
        jtr.valid_dl_iter.stop()


def test_checkpoints_load_in_either_package(tmp_path):
    jm, pm = _tiny_pair(seed=14, codebook_scale=0.5)
    jtr, ptr = _trainers(tmp_path, jm, pm, warmup_steps=3, lr=1e-4)
    try:
        ptr.train_step()
        ptr.train_step()  # Adam's moments, the schedule's count and the EMA all move
        path = tmp_path / "soundstream.2.ckpt.npz"
        ptr.save(path)
        want = _port_named(ptr.model)
        # JAX reads the model, and the whole trainer state
        shapes = jax.eval_shape(lambda: tiny_soundstream(key=jax.random.PRNGKey(0)))
        model = jckpt.load_pytree_into(str(path), shapes, prefix="['model']")
        got = jax_named(model)
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
        jtr.load(path)
        assert jtr.steps == 3
        for name, w in _port_named(ptr.ema.shadow).items():
            np.testing.assert_array_equal(jax_named(jtr.ema_state.shadow)[name], w)
        assert int(jtr.gen_opt_state[1].count) == 2 and int(jtr.gen_opt_state[2].count) == 2
        mu = codec_state_dict_from_jax(jax_named(jtr.gen_opt_state[1].mu))
        for name, p in ptr.model.named_parameters():
            if name in mu:
                np.testing.assert_array_equal(mu[name].numpy(),
                                              ptr.gen_opt.state[p]["exp_avg"].numpy())
        # and the port reads what the JAX trainer writes
        path2 = tmp_path / "jax.2.ckpt.npz"
        jtr.save(path2)
        with np.load(path2) as data:
            assert json.loads(bytes(data["__meta__"].tobytes()))["kind"] == "SoundStreamTrainer"
        _, pm2 = _tiny_pair(seed=15, codebook_scale=0.5)
        _, ptr2 = _trainers(tmp_path / "second", jm, pm2, warmup_steps=3, lr=1e-4)
        ptr2.load(path2)
        assert ptr2.steps == 3 and ptr2.ema.step == ptr.ema.step
        for name, w in want.items():
            np.testing.assert_array_equal(_port_named(ptr2.model)[name], w, err_msg=name)
        for opt, opt2, params, params2 in ((ptr.gen_opt, ptr2.gen_opt, ptr.gen_params,
                                            ptr2.gen_params),
                                           (ptr.discr_opt, ptr2.discr_opt, ptr.discr_params,
                                            ptr2.discr_params)):
            for p, p2 in zip(params, params2):
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    assert torch.equal(opt.state[p][key], opt2.state[p2][key])
        assert ptr2.gen_sched.last_epoch == ptr.gen_sched.last_epoch == 2
        assert ptr2.gen_opt.param_groups[0]["lr"] == ptr.gen_opt.param_groups[0]["lr"]
        codec = load_pytree_into(path2, SoundStream(**TINY, device="cpu"), "['ema'].shadow")
        for name, w in _port_named(ptr.ema.shadow).items():
            np.testing.assert_array_equal(_port_named(codec)[name], w)
        np.testing.assert_array_equal(
            _port_named(load_soundstream(path, device="cpu"))[".encoder_init.weight"],
            want[".encoder_init.weight"])
        ptr2.close()
    finally:
        ptr.close()
        jtr.dl_iter.stop()
        jtr.valid_dl_iter.stop()


def test_trainer_loop_saves_samples_and_resumes(tmp_path):
    folder = tmp_path / "sines"
    rng = np.random.default_rng(16)
    for i in range(4):
        paudio.save_audio(folder / f"sine_{i}.wav", _waves(rng, 1, 2048)[0], 16000)
    kw = dict(folder=folder, batch_size=2, grad_accum_every=2, num_train_steps=2,
              data_max_length=1024, save_results_every=2, save_model_every=2,
              results_folder=tmp_path / "results", warmup_steps=1, apply_grad_penalty_every=2,
              device="cpu")
    trainer = SoundStreamTrainer(SoundStream(**TINY, device="cpu"), **kw)
    try:
        trainer.train()
        assert trainer.steps == 2
        assert [p.name for p in (tmp_path / "results").glob("*.ckpt.npz")] == \
            ["soundstream.2.ckpt.npz"]
        assert sorted(p.name for p in (tmp_path / "results").glob("sample.*.wav")) == \
            ["sample.2.wav", "sample.ema.2.wav"]
        logs = [json.loads(line) for line in open(tmp_path / "results" / "metrics.jsonl")]
        assert [r["step"] for r in logs] == [0, 1] and all(np.isfinite(r["loss"]) for r in logs)
    finally:
        trainer.close()
    resumed = SoundStreamTrainer(SoundStream(**TINY, device="cpu"), **kw)
    try:
        assert resumed.resume_latest() and resumed.steps == 3
    finally:
        resumed.close()


def test_loader_keeps_the_discriminators_unless_serving():
    codec = load_soundstream(CKPT, device="cpu")
    served = load_soundstream(CKPT, device="cpu", discriminators=False)
    assert codec.discriminators is not None and served.discriminators is None
    with np.load(CKPT) as data:
        names = json.loads(bytes(data["__meta__"].tobytes()))["leaf_names"]
    assert set(_port_named(codec)) == set(names)
    assert not any(k.startswith(("discriminators", "stft_discriminator"))
                   for k in served.state_dict())
    x = t(_waves(np.random.default_rng(18), 1, 3200, 0.3))
    with torch.no_grad():
        assert torch.equal(codec.tokenize(x), served.tokenize(x))


def test_unported_trainer_options_raise(tmp_path):
    clips = _Clips(list(_waves(np.random.default_rng(17), 4, 1024)))
    kw = dict(dataset=clips, num_train_steps=1, batch_size=2, results_folder=tmp_path,
              device="cpu")
    trainer = SoundStreamTrainer(SoundStream(**TINY, device="cpu"), bf16_compute=True,
                                 apply_grad_penalty_every=2, grad_accum_every=1, **kw)
    try:
        for _ in range(2):  # a step with the penalty (float32), then one without (bfloat16)
            logs = trainer.train_step()
            assert all(np.isfinite(v) for v in logs.values()), logs
        assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
        assert all(b.dtype in (torch.float32, torch.bool) for b in trainer.model.buffers())
        assert all(v.dtype == torch.float32 for opt in (trainer.gen_opt, trainer.discr_opt)
                   for st in opt.state.values() for k, v in st.items() if k != "step")
    finally:
        trainer.close()
    with pytest.raises(NotImplementedError, match="wandb"):
        SoundStreamTrainer(SoundStream(**TINY, device="cpu"), use_wandb_tracking=True, **kw)


def test_quantizer_without_kmeans_init_starts_uniform_and_trains():
    gen = torch.Generator().manual_seed(0)
    layer = pq.VectorQuantizeEMA(32, 64, kmeans_init=False, generator=gen)
    assert bool(layer.initted) and layer.codebook.abs().max() <= 1 / 64
    assert torch.equal(layer.embed_avg, layer.codebook)
    before = layer.codebook.clone()
    x = t(np.random.default_rng(19).normal(size=(2, 40, 32)).astype(np.float32))
    out, idx, loss = layer(x, train=True, generator=gen)  # no kmeans: EMA at once
    assert out.shape == x.shape and idx.shape == (2, 40) and torch.isfinite(loss)
    assert not torch.equal(layer.codebook, before)
