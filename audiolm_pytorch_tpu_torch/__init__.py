"""PyTorch/CUDA port of the JAX AudioLM package beside it, for NVIDIA Hopper.

Imports torch and numpy only, never JAX or the JAX package. Entry points run
on the card unless the caller passes device="cpu"; on the CPU every kernel
wrapper takes its plain PyTorch version.
"""
from .device import resolve_device
from .models.audiolm import AudioLM
from .data.dataset import SoundDataset, get_dataloader
from .models.soundstream import AudioLMSoundStream, SoundStream, load_soundstream
from .models.lm import (CoarseTransformer, FineTransformer, SemanticTransformer,
                        load_coarse_transformer, load_fine_transformer,
                        load_semantic_transformer)
from .models.transformer import KVCache, Transformer
from .models.wrappers import (CoarseTransformerWrapper, FineTransformerWrapper,
                              SemanticTransformerWrapper, decode_acoustic_tokens,
                              masked_cross_entropy)
from .ops.kernels.flash_attention import (flash_attention, flash_attention_bwd_ref,
                                          flash_attention_ref)
from .ops.kernels.local_attention import local_attention, local_attention_ref
from .ops.kernels.vq import vq_nearest_code, vq_nearest_code_ref
from .training.optimizer import get_optimizer, separate_weight_decayable_params
from .training.ema import EMA
from .training.trainer import SoundStreamTrainer, TransformerTrainStep
from .utils.metrics import si_snr
from .weights import (codec_state_dict_from_jax, codec_state_dict_to_jax, read_npz,
                      state_dict_from_jax)

__all__ = ["SemanticTransformer", "SemanticTransformerWrapper", "CoarseTransformer",
           "CoarseTransformerWrapper", "FineTransformer", "FineTransformerWrapper",
           "Transformer", "KVCache", "load_semantic_transformer", "load_coarse_transformer",
           "load_fine_transformer", "masked_cross_entropy", "flash_attention",
           "flash_attention_ref", "flash_attention_bwd_ref", "TransformerTrainStep",
           "get_optimizer", "separate_weight_decayable_params", "read_npz",
           "state_dict_from_jax", "resolve_device", "SoundStream", "AudioLMSoundStream",
           "load_soundstream", "AudioLM", "decode_acoustic_tokens", "local_attention",
           "local_attention_ref", "vq_nearest_code", "vq_nearest_code_ref", "si_snr",
           "codec_state_dict_from_jax", "codec_state_dict_to_jax", "SoundStreamTrainer", "EMA",
           "SoundDataset", "get_dataloader"]
