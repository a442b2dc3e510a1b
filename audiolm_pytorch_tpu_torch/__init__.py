"""PyTorch/CUDA port of the JAX AudioLM package beside it, for NVIDIA Hopper.

Imports torch and numpy only, never JAX or the JAX package. Entry points run
on the card unless the caller passes device="cpu"; on the CPU every kernel
wrapper takes its plain PyTorch version.
"""
from .device import resolve_device
from .models.lm import SemanticTransformer, load_semantic_transformer
from .models.transformer import KVCache, Transformer
from .models.wrappers import SemanticTransformerWrapper, masked_cross_entropy
from .ops.kernels.flash_attention import (flash_attention, flash_attention_bwd_ref,
                                          flash_attention_ref)
from .training.optimizer import get_optimizer, separate_weight_decayable_params
from .training.trainer import TransformerTrainStep
from .weights import read_npz, state_dict_from_jax

__all__ = ["SemanticTransformer", "SemanticTransformerWrapper", "Transformer", "KVCache",
           "load_semantic_transformer", "masked_cross_entropy", "flash_attention",
           "flash_attention_ref", "flash_attention_bwd_ref", "TransformerTrainStep",
           "get_optimizer", "separate_weight_decayable_params", "read_npz",
           "state_dict_from_jax", "resolve_device"]
