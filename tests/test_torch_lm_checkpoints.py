"""The LM trainers' checkpoints against the JAX package's on the CPU: each
package's trainer loads the other's (the model, Adam's count and moments,
the schedule's count, the step count and the best valid loss; the same
leaf names and config), and a trainer loaded from the best checkpoint
gives the next loss bit-equal to the trainer that carries on; the
trainers, clips and tokenizers of tests/test_torch_lm_trainers.py."""
import json

import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu_torch.weights import state_dict_from_jax

from test_torch_lm_trainers import KINDS, _close, _trainer_pair, clip_folder  # noqa: F401
from torch_port_util import jax_named


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoints_load_in_either_package(kind, clip_folder, tmp_path):
    jtr, ptr = _trainer_pair(kind, clip_folder, tmp_path, lr=1e-4)
    _, ptr2 = _trainer_pair(kind, clip_folder, tmp_path / "second", seed=5, lr=1e-4)
    try:
        ptr.train_step()
        ptr.train_step()  # Adam's moments and the schedule's count move; best written
        path = tmp_path / "port" / f"{kind}.transformer.2.ckpt.npz"
        jtr.load(path)
        assert jtr.steps == 3 and jtr.best_valid == ptr.best_valid
        want = {k: v.numpy() for k, v in ptr.wrapper.transformer.state_dict().items()}
        got = state_dict_from_jax(jax_named(jtr.wrapper.transformer))
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
        assert int(jtr.opt_state[1].count) == 2 and int(jtr.opt_state[2].count) == 2
        mu = state_dict_from_jax({k[len(".transformer"):]: v
                                  for k, v in jax_named(jtr.opt_state[1].mu).items()})
        for name, p in zip(ptr.step_fn.names, ptr.step_fn.params):
            np.testing.assert_array_equal(mu[name].numpy(),
                                          ptr.step_fn.optimizer.state[p]["exp_avg"].numpy())
        # the port reads what the JAX trainer writes
        path2 = tmp_path / f"jax.{kind}.2.ckpt.npz"
        jtr.save(path2)
        with np.load(path2) as data:
            meta = json.loads(bytes(data["__meta__"].tobytes()))
        assert meta["kind"] == kind
        with np.load(path) as data:
            port_meta = json.loads(bytes(data["__meta__"].tobytes()))
        assert set(port_meta["leaf_names"]) == set(meta["leaf_names"])
        assert port_meta["config"] == meta["config"]
        ptr2.load(path2)
        assert ptr2.steps == 3 and ptr2.best_valid == ptr.best_valid
        for name, w in want.items():
            np.testing.assert_array_equal(ptr2.wrapper.transformer.state_dict()[name].numpy(),
                                          w, err_msg=name)
        st, st2 = ptr.step_fn, ptr2.step_fn
        for p, p2 in zip(st.params, st2.params):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(st.optimizer.state[p][key], st2.optimizer.state[p2][key])
        assert st2.scheduler.last_epoch == st.scheduler.last_epoch == 2
        assert st2.optimizer.param_groups[0]["lr"] == st.optimizer.param_groups[0]["lr"]
    finally:
        _close(jtr, ptr, ptr2)



def test_best_checkpoint_resumes_bit_equal(clip_folder, tmp_path):
    _, ptr = _trainer_pair("semantic", clip_folder, tmp_path, save_results_every=1, lr=1e-3)
    _, fresh = _trainer_pair("semantic", clip_folder, tmp_path / "fresh", lr=1e-3)
    try:
        for _ in range(2):
            ptr.train_step()
        best = tmp_path / "port" / "semantic.transformer.best.ckpt.npz"
        meta = json.loads(bytes(np.load(best)["__meta__"].tobytes()))
        fresh.load(best)
        assert fresh.steps == meta["steps"] + 1 and fresh.best_valid == meta["best_valid"]
        if meta["steps"] != ptr.steps:  # the best is an earlier step: carry on from there
            ptr.load(best)
        batch = torch.from_numpy(np.stack([next(ptr.dl_iter) for _ in range(2)])).reshape(4, -1)
        assert ptr.step_fn.step(raw_wave=batch) == fresh.step_fn.step(raw_wave=batch)
        # resume_latest takes the numbered checkpoint, never the best one
        assert ptr.resume_latest() and ptr.steps == 3
    finally:
        _close(ptr, fresh)
