"""AudioLM end to end, held against the JAX package's `models/audiolm.py`:
semantic ids -> coarse codes -> fine codes -> waveform, each stage a
wrapper's `generate`. Text (`text`, embedded once by the semantic stage's
T5, or `text_embeds`) goes to each stage that is conditioned; a prompt
(`prime_wave` at `prime_wave_input_sample_hz`, or a WAV file at
`prime_wave_path`, mixed to mono) is continued: the wav2vec gives the
semantic stage its ids, the codec the coarse and fine stages their codes,
each resampling the prompt to its own rate. An `audio_conditioner` goes to
the three wrappers; given a prompt and no text, each stage conditions on
the conditioner's embeddings of the prompt in its own namespace (the
Semantic wrapper does so itself; the JAX package's AudioLM asks for text
there and its Semantic stage then refuses it). `speculative` runs the
Coarse and Fine stages' speculative sampler."""
from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from ..utils.audio_io import load_audio
from .lm import CoarseTransformer, FineTransformer, SemanticTransformer
from .wrappers import CoarseTransformerWrapper, FineTransformerWrapper, SemanticTransformerWrapper

__all__ = ["AudioLM"]


class AudioLM(nn.Module):
    def __init__(self, *, wav2vec=None, codec, semantic_transformer: SemanticTransformer,
                 coarse_transformer: CoarseTransformer, fine_transformer: FineTransformer,
                 audio_conditioner=None, unique_consecutive: bool = True):
        super().__init__()
        if semantic_transformer.num_semantic_tokens != coarse_transformer.num_semantic_tokens:
            raise ValueError("the semantic and coarse LMs disagree on the semantic vocabulary")
        if coarse_transformer.codebook_size != fine_transformer.codebook_size:
            raise ValueError("the coarse and fine LMs disagree on the codebook size")
        if coarse_transformer.num_coarse_quantizers != fine_transformer.num_coarse_quantizers:
            raise ValueError("the coarse and fine LMs disagree on the coarse quantizers")
        if fine_transformer.num_coarse_quantizers + fine_transformer.num_fine_quantizers \
                != codec.num_quantizers:
            raise ValueError("coarse + fine quantizers must equal the codec's")
        cond = dict(audio_conditioner=audio_conditioner)
        self.semantic = SemanticTransformerWrapper(transformer=semantic_transformer,
                                                   wav2vec=wav2vec,
                                                   unique_consecutive=unique_consecutive, **cond)
        self.coarse = CoarseTransformerWrapper(transformer=coarse_transformer, codec=codec,
                                               wav2vec=wav2vec,
                                               unique_consecutive=unique_consecutive, **cond)
        self.fine = FineTransformerWrapper(transformer=fine_transformer, codec=codec, **cond)
        self.audio_conditioner = audio_conditioner
        self.needs_text = any(lm.has_condition for lm in (
            semantic_transformer, coarse_transformer, fine_transformer))

    @property
    def sample_rate(self):
        return self.coarse.codec.target_sample_hz

    @torch.no_grad()
    def forward(self, *, batch_size: int = 1, text=None, text_embeds=None, prime_wave=None,
                prime_wave_input_sample_hz=None, prime_wave_path=None, max_length: int = 2048,
                max_coarse_time_steps: int = 512, return_coarse_generated_wave: bool = False,
                mask_out_generated_fine_tokens: bool = False, temperature: float = 1.0,
                generator: "torch.Generator | None" = None, has_padding: "bool | None" = None,
                speculative: bool = False):
        """The waveform (B, T) generated from nothing or from the prompt, or a
        list of one per row (None for an empty row) when EOS cut rows short;
        with return_coarse_generated_wave, the decode of the coarse codes
        alone. One generator draws the three stages' samples in turn, at
        `temperature` (the JAX package samples at its default, 1; towards 0
        the stages are greedy); each conditioned stage guides at the
        wrappers' default cond_scale, 3. `has_padding` goes to the decodes
        (`decode_acoustic_tokens`): None looks for pad on the host, False
        decodes the batch at once, True row by row. With speculative, the
        Coarse and Fine stages sample speculatively (the same codes at
        temperature -> 0)."""
        prompted = prime_wave is not None or prime_wave_path is not None
        by_audio = self.audio_conditioner is not None and prompted and text is None \
            and text_embeds is None
        if self.needs_text and text is None and text_embeds is None and not by_audio:
            raise ValueError("text must be given when a transformer is text-conditioned")
        if not self.needs_text and (text is not None or text_embeds is not None):
            raise ValueError("text was given, but no transformer is text-conditioned")
        device = self.semantic.transformer.start_token.device
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(0)
        if text is not None:
            text_embeds = self.semantic.transformer.embed_text(text)
        if prime_wave is not None and prime_wave_path is not None:
            raise ValueError("pass prime_wave or prime_wave_path, not both")
        if prime_wave is not None:
            if prime_wave_input_sample_hz is None:
                raise ValueError("prime_wave needs prime_wave_input_sample_hz")
            prime_wave = torch.as_tensor(prime_wave).to(device)
        elif prime_wave_path is not None:
            path = Path(prime_wave_path)
            if not path.exists():
                raise FileNotFoundError(f"file does not exist at {path}")
            wav, prime_wave_input_sample_hz = load_audio(path)
            prime_wave = torch.from_numpy(wav.mean(axis=0))[None].to(device)  # mono (1, T)
        prompt = dict(prime_wave=prime_wave, prime_wave_input_sample_hz=prime_wave_input_sample_hz)

        def cond(wrapper, namespace):
            if not wrapper.transformer.has_condition:
                return None
            if by_audio and namespace != "semantic":
                return self.audio_conditioner(wavs=prime_wave, namespace=namespace)
            return text_embeds

        semantic = self.semantic.generate(text_embeds=cond(self.semantic, "semantic"),
                                          batch_size=batch_size, max_length=max_length,
                                          temperature=temperature, generator=generator, **prompt)
        coarse = self.coarse.generate(text_embeds=cond(self.coarse, "coarse"),
                                      semantic_token_ids=semantic,
                                      max_time_steps=max_coarse_time_steps,
                                      reconstruct_wave=return_coarse_generated_wave,
                                      temperature=temperature, generator=generator,
                                      has_padding=has_padding, speculative=speculative, **prompt)
        if return_coarse_generated_wave:
            return coarse
        return self.fine.generate(text_embeds=cond(self.fine, "fine"), coarse_token_ids=coarse,
                                  reconstruct_wave=True,
                                  mask_out_generated_fine_tokens=mask_out_generated_fine_tokens,
                                  temperature=temperature, generator=generator,
                                  has_padding=has_padding, speculative=speculative, **prompt)
