"""AudioLM end to end, held against the JAX package's `models/audiolm.py`:
semantic ids -> coarse codes -> fine codes -> waveform, each stage a
wrapper's KV-cached `generate`. Unprompted and without text conditioning:
a wav2vec, a `prime_wave` or text raises until the prompt path and the
conditioning are ported (the wrappers' training takes a wav2vec)."""
from __future__ import annotations

import torch
from torch import nn

from .lm import CoarseTransformer, FineTransformer, SemanticTransformer
from .wrappers import CoarseTransformerWrapper, FineTransformerWrapper, SemanticTransformerWrapper

__all__ = ["AudioLM"]


class AudioLM(nn.Module):
    def __init__(self, *, wav2vec=None, codec, semantic_transformer: SemanticTransformer,
                 coarse_transformer: CoarseTransformer, fine_transformer: FineTransformer,
                 unique_consecutive: bool = True):
        super().__init__()
        if wav2vec is not None:
            raise NotImplementedError("AudioLM's prompt path (wav2vec) is not ported")
        if semantic_transformer.num_semantic_tokens != coarse_transformer.num_semantic_tokens:
            raise ValueError("the semantic and coarse LMs disagree on the semantic vocabulary")
        if coarse_transformer.codebook_size != fine_transformer.codebook_size:
            raise ValueError("the coarse and fine LMs disagree on the codebook size")
        if coarse_transformer.num_coarse_quantizers != fine_transformer.num_coarse_quantizers:
            raise ValueError("the coarse and fine LMs disagree on the coarse quantizers")
        if fine_transformer.num_coarse_quantizers + fine_transformer.num_fine_quantizers \
                != codec.num_quantizers:
            raise ValueError("coarse + fine quantizers must equal the codec's")
        self.semantic = SemanticTransformerWrapper(transformer=semantic_transformer,
                                                   unique_consecutive=unique_consecutive)
        self.coarse = CoarseTransformerWrapper(transformer=coarse_transformer, codec=codec,
                                               unique_consecutive=unique_consecutive)
        self.fine = FineTransformerWrapper(transformer=fine_transformer, codec=codec)

    @torch.no_grad()
    def forward(self, *, batch_size: int = 1, text=None, text_embeds=None, prime_wave=None,
                max_length: int = 2048, max_coarse_time_steps: int = 512,
                return_coarse_generated_wave: bool = False,
                mask_out_generated_fine_tokens: bool = False, temperature: float = 1.0,
                generator: "torch.Generator | None" = None):
        """The waveform (B, T) generated from nothing, or a list of one per
        row (None for an empty row) when EOS cut rows short; with
        return_coarse_generated_wave, the decode of the coarse codes alone.
        One generator draws the three stages' samples in turn, at
        `temperature` (the JAX package samples at its default, 1; towards 0
        the stages are greedy)."""
        if text is not None or text_embeds is not None:
            raise NotImplementedError("text conditioning is not ported")
        if prime_wave is not None:
            raise NotImplementedError("AudioLM's prompt path (prime_wave) is not ported")
        if generator is None:
            generator = torch.Generator(device=self.semantic.transformer.start_token.device)
            generator.manual_seed(0)
        semantic = self.semantic.generate(batch_size=batch_size, max_length=max_length,
                                          temperature=temperature, generator=generator)
        coarse = self.coarse.generate(semantic_token_ids=semantic,
                                      max_time_steps=max_coarse_time_steps,
                                      reconstruct_wave=return_coarse_generated_wave,
                                      temperature=temperature, generator=generator)
        if return_coarse_generated_wave:
            return coarse
        return self.fine.generate(coarse_token_ids=coarse, reconstruct_wave=True,
                                  mask_out_generated_fine_tokens=mask_out_generated_fine_tokens,
                                  temperature=temperature, generator=generator)
