"""The LM trainers in bf16 compute against the JAX package's on the CPU:
two `train_step`s of each trainer with bf16_compute=True against the JAX
trainer's, as tests/test_torch_lm_trainers.py does in float32 (losses
3e-2, the whole first gradient within 5e-2 by relative norm, the valid
loss 2e-3, the best checkpoint, float32 masters)."""
import pytest

from test_torch_lm_trainers import (KINDS, check_trainer_steps, clip_folder,  # noqa: F401
                                    same_masks)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_trainer_steps_match_jax(kind, clip_folder, tmp_path, same_masks):
    check_trainer_steps(kind, True, clip_folder, tmp_path)
