"""PyTorch/CUDA port of the JAX AudioLM package beside it, for NVIDIA Hopper.

Imports torch and numpy only, never JAX or the JAX package. Entry points run
on the card unless the caller passes device="cpu"; on the CPU every kernel
wrapper takes its plain PyTorch version.
"""
from .device import resolve_device
from .models.audiolm import AudioLM
from .models.encodec import EncodecWrapper
from .models.hubert import HubertWithKmeans
from .models.vq_wav2vec import FairseqVQWav2Vec
from .data.dataset import SoundDataset, get_dataloader
from .models.soundstream import (AudioLMSoundStream, MusicLMSoundStream, SoundStream,
                                 load_soundstream)
from .models.lm import (CoarseTransformer, FineTransformer, SemanticTransformer,
                        load_coarse_transformer, load_fine_transformer,
                        load_semantic_transformer)
from .models.t5 import T5Encoder, get_encoded_dim, t5_encode_text
from .models.transformer import KVCache, Transformer
from .models.wrappers import (CoarseTransformerWrapper, FineTransformerWrapper,
                              SemanticTransformerWrapper, decode_acoustic_tokens,
                              masked_cross_entropy)
from .ops.kernels.flash_attention import (flash_attention, flash_attention_bwd_ref,
                                          flash_attention_ref)
from .ops.kernels.local_attention import local_attention, local_attention_ref
from .ops.kernels.vq import vq_nearest_code, vq_nearest_code_ref
from .ops.quantize import (FSQ, LFQ, GroupedResidualFSQ, GroupedResidualLFQ, GroupedResidualVQ,
                           ResidualFSQ, ResidualLFQ, ResidualVQ)
from .ops.resample import resample
from .serving import (StreamingCodecDecoder, StreamingCodecEncoder, decode_lookback_frames,
                      encode_lookback)
from .training.optimizer import get_optimizer, separate_weight_decayable_params
from .training.ema import EMA
from .training.trainer import (CoarseTransformerTrainer, FineTransformerTrainer,
                               SemanticTransformerTrainer, SoundStreamTrainer,
                               TransformerTrainStep)
from .utils.metrics import mel_distance, si_snr, stoi
from .weights import (codec_state_dict_from_jax, codec_state_dict_to_jax,
                      encodec_state_dict_from_jax, hubert_state_dict_from_jax,
                      lm_state_dict_to_jax, read_npz, state_dict_from_jax,
                      t5_state_dict_from_jax, vq_wav2vec_state_dict_from_jax)

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
           "SoundDataset", "get_dataloader", "HubertWithKmeans", "SemanticTransformerTrainer",
           "CoarseTransformerTrainer", "FineTransformerTrainer", "hubert_state_dict_from_jax",
           "lm_state_dict_to_jax", "T5Encoder", "t5_encode_text", "get_encoded_dim",
           "resample", "t5_state_dict_from_jax", "StreamingCodecEncoder",
           "StreamingCodecDecoder", "decode_lookback_frames", "encode_lookback", "mel_distance",
           "stoi", "MusicLMSoundStream", "EncodecWrapper", "FairseqVQWav2Vec", "LFQ", "FSQ",
           "ResidualVQ", "ResidualLFQ", "ResidualFSQ", "GroupedResidualVQ", "GroupedResidualLFQ",
           "GroupedResidualFSQ", "encodec_state_dict_from_jax", "vq_wav2vec_state_dict_from_jax"]
