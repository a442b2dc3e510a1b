"""Scoring, the training loss and KV-cached generation for the three LMs,
held against the JAX package's `models/wrappers.py` (`masked_cross_entropy`,
`_sample_from_logits`, `_semantic_generate_jit`, `_coarse_generate_jit`,
`_fine_generate_jit` on their sequential paths, the three wrappers'
`__call__`, and `decode_acoustic_tokens`). With a codec, the Coarse and Fine
wrappers also take audio (the codes of `raw_wave_for_codec`, the Coarse and
Fine prompt `prime_wave`) and give it back (`reconstruct_wave`); with a
wav2vec (`HubertWithKmeans` or `FairseqVQWav2Vec`, whose grouped ids are
flattened), the Semantic and Coarse wrappers take the semantic ids of
`raw_wave`, and the Semantic prompt `prime_wave`; a prompt
at another rate is resampled (`prime_wave_input_sample_hz`). The wav2vec
and the codec are frozen: they tokenise under no_grad, in their own dtype.

A conditioned LM takes `text` (T5-encoded once) or `text_embeds`; each
`generate` runs classifier-free guidance (`cond_scale` != 1) as one batch
of [cond | uncond] rows through one KV cache (`_cfg_tile`, `_cfg_combine`).
Under prefix conditioning there is no KV cache, as in the JAX package: each
step runs the whole sequence so far (`_Runner`). The JAX package's jitted
samplers feed only the new token there, so they lose the sequence's
history; the port does what a model without a cache must do.

An `audio_conditioner` (a callable `(wavs=, namespace=)` -> embeddings (B,
L, cond dim), such as a MuLaN-style audio encoder; `utils.AudioConditionerBase`)
conditions a wrapper's LM on its own audio: its forward takes `raw_wave` and
no text, and conditions on the conditioner's embeddings of it (namespace
"semantic", "coarse" or "fine"); the Semantic `generate` does the same with
`prime_wave`.

The Coarse and Fine `generate(speculative=True)` run the JAX package's
speculative decode (`_spec_decode_codes`): the Q codes of a time step are
drafted from the hidden state before it, checked in one length-Q cached
pass, and from the first code whose check disagrees the step is redone one
code at a time, each code sampled with its draft's Gumbel noise, so at
temperature -> 0 the codes are the sequential sampler's."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.sampling import (all_rows_have_eos_id, append_eos_id, batch_unique_consecutive,
                            generate_mask_with_prob, gumbel_noise,
                            gumbel_sample, mask_out_after_eos_id, top_k)
from ..parallel import mesh as dp
from ..parallel import tp
from .lm import CoarseTransformer, FineTransformer, SemanticTransformer
from .transformer import KVCache

__all__ = ["SemanticTransformerWrapper", "CoarseTransformerWrapper", "FineTransformerWrapper",
           "masked_cross_entropy", "sample_from_logits", "decode_acoustic_tokens"]


def masked_cross_entropy(logits, labels, ignore_index: int = -1):
    """Mean cross entropy over positions whose label is not ignore_index."""
    mask = labels != ignore_index
    ll = logits.float().log_softmax(-1)
    nll = -ll.gather(-1, labels.masked_fill(~mask, 0)[..., None].long())[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def _wav2vec_ids(wav2vec, wave, input_sample_hz=None):
    """The semantic ids (B, frames * groups) of a waveform, from the frozen
    wav2vec: a grouped one (vq-wav2vec, (B, frames, groups)) flattened with
    each frame's groups side by side, as the JAX wrappers' forward does."""
    if wav2vec is None:
        raise ValueError("raw_wave needs the wrapper's wav2vec")
    with torch.no_grad():
        ids = wav2vec(wave, flatten=False, input_sample_hz=input_sample_hz)
    return ids.reshape(ids.shape[0], -1)


def _check_wav2vec(wav2vec, num_semantic_tokens):
    if wav2vec is not None and wav2vec.codebook_size != num_semantic_tokens:
        raise ValueError(f"num_semantic_tokens must equal the wav2vec's codebook size "
                         f"{wav2vec.codebook_size}")


def sample_from_logits(logits, filter_thres: float, temperature: float, *,
                       generator: "torch.Generator | None" = None, noise=None):
    """Gumbel-max over the top (1 - filter_thres) of logits at temperature,
    with the Gumbel `noise` given (logits' shape) or drawn from generator."""
    return gumbel_sample(top_k(logits, thres=filter_thres), temperature, generator=generator,
                         noise=noise)


def _audio_condition(conditioner, wave, text, text_embeds, namespace):
    """text_embeds of a wrapper with an audio conditioner: its embeddings of
    `wave` (which must be given, with no text); without a conditioner,
    text_embeds as given."""
    if conditioner is None:
        return text_embeds
    if wave is None or text is not None or text_embeds is not None:
        raise ValueError("with an audio_conditioner, pass the audio and no text or text_embeds")
    return conditioner(wavs=wave, namespace=namespace)


def _check_conditioner(conditioner, lm):
    if conditioner is not None and not lm.has_condition:
        raise ValueError("an audio_conditioner needs a transformer with has_condition")


def _returns(out, logits_buf, return_logits, spec_stats, return_spec_stats):
    """generate's result: out, with the logits and the speculative stats
    after it when asked for."""
    extra = ((logits_buf,) if return_logits else ()) + \
        ((spec_stats,) if return_spec_stats else ())
    return (out, *extra) if extra else out


def _cfg_tile(x, use_cfg: bool):
    return torch.cat([x, x]) if use_cfg and x is not None else x


def _cfg_combine(logits, cond_scale: float, use_cfg: bool):
    if not use_cfg:
        return logits
    cond, null = logits.chunk(2)
    return null + (cond - null) * cond_scale


def _generation_condition(lm, text, text_embeds, cond_scale, device):
    """(context, its key mask, use_cfg) of a generate call: the text's T5
    embeddings (or text_embeds), their mask any(embeds != 0), both doubled
    for classifier-free guidance ([cond | uncond], the uncond half's mask
    cleared) and the embeddings projected; (None, None, False) for an
    unconditioned LM."""
    has_text = text is not None or text_embeds is not None
    if lm.has_condition != has_text:
        raise ValueError("has_condition and the presence of text / text_embeds must agree")
    if not has_text:
        return None, None, False
    if text_embeds is None:
        text_embeds = lm.embed_text(text)
    text_embeds = text_embeds.to(device)
    mask = (text_embeds != 0).any(-1)
    use_cfg = cond_scale != 1
    if use_cfg:
        mask = torch.cat([mask, torch.zeros_like(mask)])
    return lm._proj_text(_cfg_tile(text_embeds, use_cfg)), mask, use_cfg


class _Runner:
    """The transformer calls of one generation: the prompt, then each new
    token, every row doubled for classifier-free guidance. With a KV cache
    (length `total`) only the new tokens run. Under prefix conditioning,
    which has no cache, the whole sequence so far runs at each call, with
    the key mask and the bias cut to its length, and the outputs of the new
    positions are returned."""

    def __init__(self, t, batch: int, total: int, dtype, device, *, use_cfg: bool,
                 context=None, context_mask=None, self_attn_mask=None, attn_bias=None):
        self.t, self.use_cfg = t, use_cfg
        self.kw = dict(context=context, context_mask=context_mask)
        self.mask, self.bias = _cfg_tile(self_attn_mask, use_cfg), attn_bias
        self.cache = None if t.cond_as_self_attn_prefix else KVCache.create(
            t.depth, batch * (2 if use_cfg else 1), total, t.dim_head, dtype=dtype,
            device=device)
        self.seq = None

    def __call__(self, x):
        x = _cfg_tile(x, self.use_cfg)
        if self.cache is not None:
            return self.t(x, self_attn_mask=self.mask, attn_bias=self.bias,
                          kv_cache=self.cache, **self.kw)
        self.seq = x if self.seq is None else torch.cat([self.seq, x], dim=1)
        n = self.seq.shape[1]
        mask = None if self.mask is None else self.mask[:, :n]
        bias = None if self.bias is None else self.bias[:, :n, :n]
        return self.t(self.seq, self_attn_mask=mask, attn_bias=bias, **self.kw)[:, n - x.shape[1]:]


def _scoring_condition(lm, text, text_embeds):
    """text_embeds of a wrapper's forward: the T5 embeddings of `text`."""
    if text is not None and text_embeds is None:
        return lm.embed_text(text)
    return text_embeds


class SemanticTransformerWrapper(nn.Module):
    """Scores semantic token sequences, gives the training loss and samples
    continuations."""

    def __init__(self, *, transformer: SemanticTransformer, wav2vec=None, audio_conditioner=None,
                 pad_id: int = -1, unique_consecutive: bool = True, mask_prob: float = 0.15):
        super().__init__()
        _check_wav2vec(wav2vec, transformer.num_semantic_tokens)
        _check_conditioner(audio_conditioner, transformer)
        self.transformer = transformer
        self.wav2vec = wav2vec
        self.audio_conditioner = audio_conditioner
        self.pad_id = pad_id
        self.eos_id = transformer.eos_id
        self.unique_consecutive = unique_consecutive
        self.mask_prob = mask_prob

    def forward(self, semantic_token_ids=None, *, raw_wave=None, text=None, text_embeds=None,
                cond_scale: "float | None" = None, return_loss: bool = False,
                train: bool = False, generator: "torch.Generator | None" = None):
        """Logits (B, N, V) of the ids (or of the wav2vec's ids of
        `raw_wave`), or with return_loss the mean next-token cross entropy.
        With train, EOS is appended first and the forgetful causal mask
        (mask_prob of the keys dropped per row, drawn from `generator`) is
        applied. Consecutive repeats are dropped after EOS is appended. A
        conditioned LM takes text or text_embeds; in training each row's
        condition is dropped with the LM's cond_drop_prob (drawn from
        `generator`), else never; with cond_scale, the logits of
        classifier-free guidance. With an audio_conditioner, the condition
        is its embeddings of raw_wave."""
        text_embeds = _audio_condition(self.audio_conditioner, raw_wave, text, text_embeds,
                                       "semantic")
        if semantic_token_ids is None:
            semantic_token_ids = _wav2vec_ids(self.wav2vec, raw_wave)
        ids = semantic_token_ids.reshape(semantic_token_ids.shape[0], -1)
        if train:
            ids = append_eos_id(ids, self.eos_id)
        if self.unique_consecutive:
            ids = batch_unique_consecutive(ids, pad_value=self.pad_id)
        input_ids = ids[:, :-1] if return_loss else ids
        mask = None
        if train and self.mask_prob > 0:
            mask = generate_mask_with_prob(input_ids.shape, self.mask_prob,
                                           generator=generator, device=input_ids.device)
        cond = dict(text_embeds=_scoring_condition(self.transformer, text, text_embeds),
                    self_attn_mask=mask)
        if cond_scale is not None:
            logits = self.transformer.forward_with_cond_scale(input_ids, cond_scale=cond_scale,
                                                              **cond)
        else:
            logits = self.transformer(input_ids, cond_drop_prob=None if train else 0.0,
                                      generator=generator, **cond)
        if not return_loss:
            return logits
        return masked_cross_entropy(logits, ids, self.pad_id)

    @torch.no_grad()
    def generate(self, *, max_length: int, prime_ids=None, prime_wave=None,
                 prime_wave_input_sample_hz=None, text=None, text_embeds=None,
                 cond_scale: float = 3.0, batch_size: int = 1, filter_thres: float = 0.9,
                 temperature: float = 1.0, generator: "torch.Generator | None" = None,
                 return_logits: bool = False, mesh=None):
        """Sample up to max_length ids after the prompt `prime_ids` (B, P) or
        the wav2vec's ids of `prime_wave`, stopping once every row holds EOS;
        the EOS and what follows become pad. One prefill of [start] +
        prompt, then one cached step per token (under prefix conditioning
        the whole sequence each step). A conditioned LM takes text or
        text_embeds, with guidance at cond_scale; with an audio_conditioner
        and prime_wave, the condition is its embeddings of prime_wave. With
        return_logits, also the (B, max_length + 1, V) logits each position
        was sampled from (zeros past the last step). With a data-parallel
        `mesh` (`parallel.mesh.make_mesh`) the batch is split over its
        data ranks: each generates its rows (the prompt's, the condition's,
        its share of batch_size), with its rows of the whole batch's noise,
        and every rank returns the whole batch, the ids of the unsharded
        run. A mesh with a model dimension also shards the LM over it, in
        place (`parallel.tp.apply_tp_sharding`, nothing when it already
        is): the ranks of a model group compute each step together and draw
        the same noise."""
        if mesh is not None:
            tp.apply_tp_sharding(self, mesh)
            with dp.data_parallel(mesh) as scope:
                def cut(x):
                    n = len(x) // scope.world
                    if len(x) % scope.world:
                        raise ValueError(f"batch {len(x)} does not split over {scope.world} ranks")
                    return x[scope.rank * n:(scope.rank + 1) * n]

                out = self.generate(
                    max_length=max_length, prime_wave_input_sample_hz=prime_wave_input_sample_hz,
                    **{k: None if v is None else cut(v) for k, v in dict(
                        prime_ids=prime_ids, prime_wave=prime_wave, text=text,
                        text_embeds=text_embeds).items()},
                    cond_scale=cond_scale, batch_size=len(cut(range(batch_size)))
                    if prime_ids is None and prime_wave is None else 1,
                    filter_thres=filter_thres, temperature=temperature, generator=generator,
                    return_logits=return_logits)
                return tuple(map(dp.gather_rows, out)) if return_logits else dp.gather_rows(out)
        tr = self.transformer
        device = tr.start_token.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if self.audio_conditioner is not None and prime_wave is not None:
            text_embeds = _audio_condition(self.audio_conditioner, prime_wave, text, text_embeds,
                                           "semantic")
        if prime_wave is not None:
            if prime_ids is not None:
                raise ValueError("pass prime_wave or prime_ids, not both")
            ids = _wav2vec_ids(self.wav2vec, prime_wave.to(device), prime_wave_input_sample_hz)
        elif prime_ids is not None:
            ids = prime_ids.to(device)
        else:
            ids = torch.zeros((batch_size, 0), dtype=torch.long, device=device)
        if self.unique_consecutive and ids.shape[-1] > 0:
            ids = batch_unique_consecutive(ids, pad_value=self.pad_id)
        b, p = ids.shape
        vocab = tr.num_semantic_tokens + 1
        context, context_mask, use_cfg = _generation_condition(tr, text, text_embeds,
                                                               cond_scale, device)
        run = _Runner(tr.transformer, b, max_length + 1, tr.start_token.dtype, device,
                      use_cfg=use_cfg, context=context, context_mask=context_mask)

        def logits_of(out):
            return _cfg_combine(tr.logits(out), cond_scale, use_cfg)

        logits = logits_of(run(tr.embed_ids(ids)))  # (B, P+1, V)
        ids_buf = torch.full((b, max_length), self.pad_id, dtype=torch.long, device=device)
        ids_buf[:, :p] = ids
        logits_buf = torch.zeros((b, max_length + 1, vocab), dtype=logits.dtype, device=device)
        logits_buf[:, : p + 1] = logits
        last_idx = (ids != self.pad_id).sum(-1)
        rows = torch.arange(b, device=device)
        for pos in range(p, max_length):
            if bool((ids_buf == self.eos_id).any(-1).all()):
                break
            sampled = sample_from_logits(logits_buf[rows, last_idx], filter_thres,
                                         temperature, generator=generator)
            ids_buf[:, pos] = sampled
            logits_buf[:, pos + 1] = logits_of(run(tr.embed_semantic(sampled[:, None])))[:, 0]
            last_idx += 1
        ids_out = mask_out_after_eos_id(ids_buf, self.eos_id, mask_value=self.pad_id,
                                        keep_eos=False)
        return (ids_out, logits_buf) if return_logits else ids_out


def _decode_codes(step, heads, embed_code, last_out, buf, start: int, *,
                  eos_id: "int | None", filter_thres, temperature, generator, logits_buf,
                  combine=lambda h: h):
    """The sequential sampler of the Coarse and Fine wrappers: for each code
    i from `start` on, the logits of position i through head i % Q (`heads`,
    `_Heads`) of the hidden state `combine` gives (guidance's mix of the
    [cond | uncond] rows) (the last class, EOS for the coarse heads, only at
    a time-step boundary after the first step), one sample, and `step` (one
    transformer step) on its embedding. With eos_id, stops once every row
    holds EOS. Fills buf (B, n) in place and, when given, logits_buf (B, n,
    C) with the logits before the EOS masking."""
    num_q = heads.num_q
    for i in range(start, buf.shape[1]):
        if eos_id is not None and all_rows_have_eos_id(buf, eos_id):
            break
        q = i % num_q
        logits = _head_logits(combine(last_out), heads, q, None)
        if logits_buf is not None:
            logits_buf[:, i] = logits
        sampled = sample_from_logits(_mask_last(logits, q == 0 and i > 0), filter_thres,
                                     temperature, generator=generator)
        buf[:, i] = sampled
        last_out = step(embed_code(sampled, q)[:, None])[:, -1]


class _Heads:
    """An LM's per-quantizer logit heads as the samplers use them: `num_q`
    heads over `vocab` classes, the whole logits of each on every rank
    (`head_logits`, tensor-parallel or not)."""

    def __init__(self, lm, key: str, vocab: int):
        self.lm, self.key, self.vocab = lm, key, vocab
        self.num_q = getattr(lm, key).shape[0]

    def __call__(self, hidden, q: int):
        return self.lm.head_logits(self.key, hidden, q)


def _head_logits(hidden, heads, q, allow_last):
    """The logits of head q; with allow_last False or True, the last class
    (EOS for the coarse heads) masked or kept (None: the raw logits)."""
    logits = heads(hidden, q)
    return logits if allow_last is None else _mask_last(logits, allow_last)


def _mask_last(logits, allow_last: bool):
    if allow_last:
        return logits
    logits = logits.clone()
    logits[:, -1] = float("-inf")
    return logits


def _spec_decode_codes(run, heads, embed_code, last_out, buf, start: int, *,
                       eos_id: "int | None", filter_thres, temperature, generator,
                       combine=lambda h: h):
    """The speculative sampler of the Coarse and Fine wrappers (the JAX
    package's `_spec_decode_loop`), over whole time steps of Q codes from
    `start` (a multiple of Q) on. For each: the step's Gumbel noise for its Q
    codes drawn at once; code 0 sampled from the hidden state before the
    step (its last class allowed after the first step), codes 1..Q-1
    drafted from that same state; the Q drafts run in one cached pass; each
    draft j >= 1 checked against the code sampled, with its noise, from the
    pass's output at j - 1. From the first code A that disagrees in any row,
    the cache is rewound to A (its keys and values before A depend only on
    the accepted codes) and codes A..Q-1 are sampled and run one at a time,
    each with its own noise. With eos_id, stops before a step once every
    row holds EOS. Fills buf (B, n) in place; returns (accepted, steps): the
    codes taken from the one-pass check (A a step) and the steps run."""
    cache = run.cache
    num_q = heads.num_q
    b = buf.shape[0]
    accepted = steps = 0
    for i0 in range(start, buf.shape[1] - num_q + 1, num_q):
        if eos_id is not None and all_rows_have_eos_id(buf, eos_id):
            break
        hidden0 = combine(last_out)
        noise = gumbel_noise((b, num_q, heads.vocab), generator=generator, device=buf.device)

        def sample(hidden, j):
            logits = _head_logits(hidden, heads, j, j == 0 and i0 > 0)
            return sample_from_logits(logits, filter_thres, temperature, noise=noise[:, j])

        draft = [sample(hidden0, j) for j in range(num_q)]
        pos = cache.pos
        outs = run(torch.stack([embed_code(draft[j], j) for j in range(num_q)], 1)
                   .to(last_out.dtype))
        codes, agree = draft[:1], num_q
        for j in range(1, num_q):
            codes.append(sample(combine(outs[:, j - 1]), j))
            if agree == num_q and bool((codes[j] != draft[j]).any()):
                agree = j
        last_out = outs[:, agree - 1]
        if agree < num_q:
            cache.pos = pos + agree
            for j in range(agree, num_q):
                codes[j] = sample(combine(last_out), j)
                last_out = run(embed_code(codes[j], j)[:, None].to(last_out.dtype))[:, -1]
        buf[:, i0:i0 + num_q] = torch.stack(codes, 1)
        accepted += agree
        steps += 1
    return accepted, steps


def _spec_or_sequential(speculative, aligned, run, heads, embed_code, last_out, buf,
                        start, logits_buf, kw):
    """The speculative sampler when `speculative` and `aligned` (where the
    JAX package takes it), else the sequential one; dict(accepted=, steps=)
    of the drafts (0 and 0 from the sequential sampler)."""
    if speculative and run.cache is None:
        raise ValueError("speculative decode rewinds the KV cache, and prefix conditioning "
                         "(cond_as_self_attn_prefix) runs without one: use speculative=False")
    if not (speculative and aligned):
        _decode_codes(run, heads, embed_code, last_out, buf, start,
                      logits_buf=logits_buf, **kw)
        return dict(accepted=0, steps=0)
    if logits_buf is not None:
        raise ValueError("return_logits is for the sequential sampler: pass speculative=False")
    accepted, steps = _spec_decode_codes(run, heads, embed_code, last_out, buf, start, **kw)
    return dict(accepted=accepted, steps=steps)


def _codec_codes(codec, wave, input_sample_hz=None):
    """The (B, N, G * Q) codes of a waveform, from the codec in eval mode."""
    if codec is None:
        raise ValueError("audio in needs the wrapper's codec")
    with torch.no_grad():
        return codec(wave, return_encoded=True, input_sample_hz=input_sample_hz)[1]


class CoarseTransformerWrapper(nn.Module):
    """Scores (semantic ids, coarse codes) pairs, gives the training loss and
    samples coarse codes for given semantic ids. With a codec, the coarse
    codes may come from audio and the samples go back to audio."""

    def __init__(self, *, transformer: CoarseTransformer, codec=None, wav2vec=None,
                 audio_conditioner=None, pad_id: int = -1, unique_consecutive: bool = True,
                 mask_prob: float = 0.15):
        super().__init__()
        _check_wav2vec(wav2vec, transformer.num_semantic_tokens)
        _check_conditioner(audio_conditioner, transformer)
        self.transformer = transformer
        self.codec = codec
        self.wav2vec = wav2vec
        self.audio_conditioner = audio_conditioner
        self.pad_id = pad_id
        self.unique_consecutive = unique_consecutive
        self.mask_prob = mask_prob
        self.num_coarse_quantizers = transformer.num_coarse_quantizers * \
            (codec.rq_groups if codec is not None else 1)
        self.semantic_eos_id = transformer.semantic_eos_id
        self.coarse_eos_id = transformer.coarse_eos_id

    def forward(self, semantic_token_ids=None, coarse_token_ids=None, *, raw_wave=None,
                raw_wave_for_codec=None, text=None, text_embeds=None,
                cond_scale: "float | None" = None, return_loss: bool = False,
                train: bool = False, generator: "torch.Generator | None" = None):
        """(semantic logits, coarse logits), or with return_loss the loss:
        each head's cross entropy weighted by its count of labels (the JAX
        wrapper's loss weights at their default, 1). Without
        semantic_token_ids, the wav2vec's ids of `raw_wave`; without
        coarse_token_ids, the codec's first coarse codes of
        `raw_wave_for_codec`, which defaults to raw_wave. With train, EOS is appended to both streams and
        the forgetful causal mask (drawn from `generator`) joins the key
        mask, which always drops the semantic pad and EOS ids. The
        condition as the Semantic wrapper's (the audio conditioner's
        namespace "coarse")."""
        text_embeds = _audio_condition(self.audio_conditioner, raw_wave, text, text_embeds,
                                       "coarse")
        if semantic_token_ids is None:
            semantic_token_ids = _wav2vec_ids(self.wav2vec, raw_wave)
        if raw_wave_for_codec is None:
            raw_wave_for_codec = raw_wave
        b = semantic_token_ids.shape[0]
        if coarse_token_ids is None:
            coarse_token_ids = _codec_codes(self.codec, raw_wave_for_codec)[
                ..., :self.num_coarse_quantizers]
        sem = semantic_token_ids.reshape(b, -1)
        coarse = coarse_token_ids.reshape(b, -1)
        if train:
            sem = append_eos_id(sem, self.semantic_eos_id)
            coarse = append_eos_id(coarse, self.coarse_eos_id)
        if self.unique_consecutive:
            sem = batch_unique_consecutive(sem, pad_value=self.pad_id)
        sem_labels, coarse_labels = sem, coarse
        if return_loss:
            coarse = coarse[:, :-1]
        keep = (sem != self.pad_id) & (sem != self.semantic_eos_id)
        sem = sem.masked_fill(~keep, 0)
        mask = torch.nn.functional.pad(keep, (1, coarse.shape[-1] + 1), value=True)
        if train and self.mask_prob > 0:
            mask = mask & generate_mask_with_prob(mask.shape, self.mask_prob,
                                                  generator=generator, device=mask.device)
        cond = dict(text_embeds=_scoring_condition(self.transformer, text, text_embeds),
                    self_attn_mask=mask)
        if cond_scale is not None:
            semantic_logits, coarse_logits = self.transformer.forward_with_cond_scale(
                sem, coarse, cond_scale=cond_scale, **cond)
        else:
            semantic_logits, coarse_logits = self.transformer(
                sem, coarse, cond_drop_prob=None if train else 0.0, generator=generator, **cond)
        if not return_loss:
            return semantic_logits, coarse_logits
        # the counts as the JAX wrapper takes them: all labels, or all logits
        num_coarse = coarse_labels.numel() if self.unique_consecutive else coarse_logits.shape[1]
        num_semantic, semantic_loss = 0, 0.0
        if semantic_logits is not None:
            num_semantic = (sem_labels != self.pad_id).sum() if self.unique_consecutive \
                else semantic_logits.shape[1]
            semantic_loss = masked_cross_entropy(semantic_logits, sem_labels, self.pad_id)
        coarse_loss = masked_cross_entropy(coarse_logits, coarse_labels, self.pad_id)
        return (semantic_loss * num_semantic + coarse_loss * num_coarse) / (num_semantic
                                                                             + num_coarse)

    @torch.no_grad()
    def generate(self, *, semantic_token_ids, prime_coarse_token_ids=None, prime_wave=None,
                 prime_wave_input_sample_hz=None, text=None, text_embeds=None,
                 cond_scale: float = 3.0, max_time_steps: int = 512, filter_thres: float = 0.9,
                 temperature: float = 1.0, reconstruct_wave: bool = False,
                 generator: "torch.Generator | None" = None, return_logits: bool = False,
                 has_padding: "bool | None" = None, speculative: bool = False,
                 return_spec_stats: bool = False):
        """Sample max_time_steps x Q coarse codes after the prompt
        `prime_coarse_token_ids` (B, Pc), or the codec's first Q codes of
        `prime_wave`, for semantic ids (B, S) (-1 pads embed to 0). One
        prefill of [start, semantic, start, prompt], then one cached step per
        code (under prefix conditioning the whole sequence each step); stops
        once every row holds EOS, and EOS and what follows become -1. A
        conditioned LM takes text or text_embeds, with guidance at
        cond_scale. Returns the (B, T, Q) grid of the prompt and the
        samples, T = Pc / Q + max_time_steps, or with reconstruct_wave the
        codec's decode of it (`decode_acoustic_tokens`, with `has_padding`);
        with return_logits also the (B, T * Q, cb + 1) logits each code was
        sampled from (zeros for the prompt and past the last step). With
        speculative and a prompt of whole time steps, the speculative
        sampler (`_spec_decode_codes`), else the sequential one; with
        return_spec_stats also dict(accepted=, steps=, num_q=) (0 and 0 from
        the sequential sampler; None without speculative), as JAX returns
        them."""
        tr = self.transformer
        device = tr.coarse_start_token.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        b = semantic_token_ids.shape[0]
        if prime_wave is not None:
            if prime_coarse_token_ids is not None:
                raise ValueError("pass prime_wave or prime_coarse_token_ids, not both")
            prime_coarse_token_ids = _codec_codes(self.codec, prime_wave.to(device),
                                                  prime_wave_input_sample_hz)[
                ..., :self.num_coarse_quantizers]
        sem = semantic_token_ids.to(device)
        if self.unique_consecutive:
            sem = batch_unique_consecutive(sem, pad_value=self.pad_id)
        s = sem.shape[1]
        prime = prime_coarse_token_ids.to(device).reshape(b, -1) \
            if prime_coarse_token_ids is not None else sem.new_zeros(b, 0)
        pc, num_q = prime.shape[1], self.num_coarse_quantizers
        n_total = pc + max_time_steps * num_q
        dtype = tr.coarse_start_token.dtype
        total = 1 + s + 1 + n_total  # semantic start, semantic, coarse start, coarse
        bias = tr.build_attn_bias(s, total)
        context, context_mask, use_cfg = _generation_condition(tr, text, text_embeds,
                                                               cond_scale, device)
        run = _Runner(tr.transformer, b, total, dtype, device, use_cfg=use_cfg,
                      context=context, context_mask=context_mask, attn_bias=bias)
        tokens = torch.cat([tr.semantic_start_token.expand(b, 1, -1), tr.embed_semantic(sem),
                            tr.coarse_start_token.expand(b, 1, -1), tr.embed_coarse(prime)], 1)
        last_out = run(tokens.to(dtype))[:, -1]
        buf = torch.zeros(b, n_total, dtype=torch.long, device=device)
        buf[:, :pc] = prime
        logits_buf = buf.new_zeros(b, n_total, tr.codebook_size + 1, dtype=dtype) \
            if return_logits else None
        kw = dict(eos_id=self.coarse_eos_id, filter_thres=filter_thres, temperature=temperature,
                  generator=generator, combine=lambda h: _cfg_combine(h, cond_scale, use_cfg))
        spec_stats = _spec_or_sequential(
            speculative, pc % num_q == 0, run,
            _Heads(tr, "coarse_logit_weights", tr.codebook_size + 1), tr.embed_code,
            last_out, buf, pc, logits_buf, kw)
        buf = mask_out_after_eos_id(buf, self.coarse_eos_id, mask_value=-1, keep_eos=False)
        out = buf.reshape(b, -1, num_q)
        if reconstruct_wave:
            out = decode_acoustic_tokens(self.codec, out, pad_id=-1, has_padding=has_padding)
        return _returns(out, logits_buf, return_logits,
                        dict(spec_stats, num_q=num_q) if speculative else None,
                        return_spec_stats)


class FineTransformerWrapper(nn.Module):
    """Scores (coarse codes, fine codes) pairs, gives the training loss and
    samples the fine codes of given coarse codes. With a codec, the codes
    and the prompt may come from audio and the samples go back to audio."""

    def __init__(self, *, transformer: FineTransformer, codec=None, audio_conditioner=None,
                 pad_id: int = -1, mask_prob: float = 0.15):
        super().__init__()
        _check_conditioner(audio_conditioner, transformer)
        self.transformer = transformer
        self.codec = codec
        self.audio_conditioner = audio_conditioner
        groups = codec.rq_groups if codec is not None else 1
        self.num_coarse_quantizers = transformer.num_coarse_quantizers * groups
        self.num_fine_quantizers = transformer.num_fine_quantizers * groups
        if codec is not None and self.num_coarse_quantizers + self.num_fine_quantizers != \
                codec.num_quantizers * codec.rq_groups:
            raise ValueError("coarse + fine quantizers must equal the codec's")
        self.pad_id = pad_id
        self.mask_prob = mask_prob

    def forward(self, coarse_token_ids=None, fine_token_ids=None, *, raw_wave=None,
                raw_wave_for_codec=None, text=None, text_embeds=None,
                cond_scale: "float | None" = None, return_loss: bool = False,
                train: bool = False, generator: "torch.Generator | None" = None):
        """(coarse logits, fine logits), or with return_loss the loss: each
        head's cross entropy weighted by its count of logits (the JAX
        wrapper's loss weight at its default, 1). With `raw_wave` (the JAX
        wrapper's name) or `raw_wave_for_codec`, both come from the codec's
        codes of it. With train, the forgetful causal mask (drawn from
        `generator`) is applied. The condition as the Semantic wrapper's
        (the audio conditioner's namespace "fine", of raw_wave)."""
        text_embeds = _audio_condition(self.audio_conditioner, raw_wave, text, text_embeds,
                                       "fine")
        if raw_wave is not None:
            if raw_wave_for_codec is not None:
                raise ValueError("pass raw_wave or raw_wave_for_codec, not both")
            raw_wave_for_codec = raw_wave
        if raw_wave_for_codec is not None:
            codes = _codec_codes(self.codec, raw_wave_for_codec)
            coarse_token_ids = codes[..., :self.num_coarse_quantizers]
            fine_token_ids = codes[..., self.num_coarse_quantizers:]
        b = coarse_token_ids.shape[0]
        coarse = coarse_token_ids.reshape(b, -1)
        fine = fine_token_ids.reshape(b, -1)
        coarse_labels, fine_labels = coarse, fine
        if return_loss:
            fine = fine[:, :-1]
        mask = None
        if train and self.mask_prob > 0:
            mask = generate_mask_with_prob((b, coarse.shape[-1] + fine.shape[-1] + 2),
                                           self.mask_prob, generator=generator,
                                           device=coarse.device)
        cond = dict(text_embeds=_scoring_condition(self.transformer, text, text_embeds),
                    self_attn_mask=mask)
        if cond_scale is not None:
            coarse_logits, fine_logits = self.transformer.forward_with_cond_scale(
                coarse, fine, cond_scale=cond_scale, **cond)
        else:
            coarse_logits, fine_logits = self.transformer(
                coarse, fine, cond_drop_prob=None if train else 0.0, generator=generator, **cond)
        if not return_loss:
            return coarse_logits, fine_logits
        num_fine = fine_logits.shape[1]
        coarse_loss, num_coarse = 0.0, 0
        if coarse_logits is not None:
            num_coarse = coarse_logits.shape[1]
            coarse_loss = masked_cross_entropy(coarse_logits, coarse_labels, self.pad_id)
        fine_loss = masked_cross_entropy(fine_logits, fine_labels, self.pad_id)
        return (coarse_loss * num_coarse + fine_loss * num_fine) / (num_coarse + num_fine)

    @torch.no_grad()
    def generate(self, *, coarse_token_ids, prime_wave=None, prime_wave_input_sample_hz=None,
                 prime_fine_token_ids=None, text=None, text_embeds=None,
                 cond_scale: float = 3.0, filter_thres: float = 0.9, temperature: float = 1.0,
                 reconstruct_wave: bool = False, mask_out_generated_fine_tokens: bool = False,
                 generator: "torch.Generator | None" = None, return_logits: bool = False,
                 has_padding: "bool | None" = None, speculative: bool = False,
                 return_spec_stats: bool = False):
        """Sample the fine codes of coarse codes (B, T, Qc) or (B, T * Qc),
        after the prompt `prime_fine_token_ids` (B, Pf), or the codec's fine
        codes of `prime_wave`. One prefill of [start, coarse, start, prompt]
        under a bias of the whole fine budget and the key mask that drops
        coarse pad and EOS codes, then one cached step per code, T * Qf in
        all (under prefix conditioning the whole sequence each step). A
        conditioned LM takes text or text_embeds, with guidance at
        cond_scale. Returns the (B, T, Qf) grid, or with reconstruct_wave the
        codec's decode of the coarse and fine grids together
        (`decode_acoustic_tokens`, with `has_padding`); with
        mask_out_generated_fine_tokens, the time steps whose coarse codes are
        all pad become pad; with return_logits also the (B, T * Qf, cb)
        logits each code was sampled from (zeros for the prompt).
        speculative and return_spec_stats as the Coarse wrapper's (the
        speculative sampler needs a prompt of whole time steps and at least
        one step)."""
        tr = self.transformer
        device = tr.coarse_start_token.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        b = coarse_token_ids.shape[0]
        coarse = coarse_token_ids.to(device).reshape(b, -1)
        nc, qc, qf = coarse.shape[1], self.num_coarse_quantizers, self.num_fine_quantizers
        steps = nc // qc
        n_total = steps * qf
        if prime_wave is not None and prime_fine_token_ids is not None:
            raise ValueError("pass prime_wave or prime_fine_token_ids, not both")
        if prime_wave is not None:
            prime_fine_token_ids = _codec_codes(self.codec, prime_wave.to(device),
                                                prime_wave_input_sample_hz)[..., qc:]
        prime = prime_fine_token_ids.to(device).reshape(b, -1) \
            if prime_fine_token_ids is not None else coarse.new_zeros(b, 0)
        pf = prime.shape[1]
        dtype = tr.coarse_start_token.dtype
        bias = tr.build_attn_bias(nc, n_total)
        key_mask, coarse_safe = tr.coarse_key_mask(coarse, n_total)
        context, context_mask, use_cfg = _generation_condition(tr, text, text_embeds,
                                                               cond_scale, device)
        run = _Runner(tr.transformer, b, 2 + nc + n_total, dtype, device, use_cfg=use_cfg,
                      context=context, context_mask=context_mask, self_attn_mask=key_mask,
                      attn_bias=bias)
        tokens = torch.cat([tr.coarse_start_token.expand(b, 1, -1), tr.embed_coarse(coarse_safe),
                            tr.fine_start_token.expand(b, 1, -1), tr.embed_fine(prime)], 1)
        last_out = run(tokens.to(dtype))[:, -1]
        buf = torch.zeros(b, n_total, dtype=torch.long, device=device)
        buf[:, :pf] = prime
        logits_buf = buf.new_zeros(b, n_total, tr.codebook_size, dtype=dtype) \
            if return_logits else None

        # the fine heads have no EOS class: no early exit, and no EOS to mask out after
        kw = dict(eos_id=None, filter_thres=filter_thres, temperature=temperature,
                  generator=generator, combine=lambda h: _cfg_combine(h, cond_scale, use_cfg))
        spec_stats = _spec_or_sequential(
            speculative, pf % qf == 0 and n_total > 0, run,
            _Heads(tr, "fine_logit_weights", tr.codebook_size), tr.embed_code, last_out, buf,
            pf, logits_buf, kw)
        grid = buf.reshape(b, steps, qf)
        coarse_grid = coarse.reshape(b, steps, qc)
        if mask_out_generated_fine_tokens:
            all_pad = (coarse_grid == self.pad_id).all(-1, keepdim=True)
            grid = grid.masked_fill(all_pad, self.pad_id)
        if reconstruct_wave:
            grid = decode_acoustic_tokens(self.codec, torch.cat([coarse_grid, grid], -1),
                                          pad_id=self.pad_id, has_padding=has_padding)
        return _returns(grid, logits_buf, return_logits,
                        dict(spec_stats, num_q=qf) if speculative else None, return_spec_stats)


def decode_acoustic_tokens(codec, token_grid, pad_id: int = -1, length_bucket: int = 64,
                           has_padding: "bool | None" = None):
    """The waveform of codes (B, N, Q), Q at most the codec's quantizers: one
    batched decode when no code is pad, else one decode per row of its
    frames without pad (None for a row with none), padded up to a multiple
    of `length_bucket` frames by repeating the last frame and trimmed back
    to its true length, as the JAX package does. Decoding fewer frames than
    the causal convolutions' pad takes the reflect pad past the input's
    length (`ops/conv.py::reflect_pad_left`). `has_padding`, as in JAX:
    None looks for pad on the host (a device sync), False trusts the caller
    and takes the batched decode with no sync, True takes the per-row
    path."""
    if codec is None:
        raise ValueError("reconstruct_wave needs the wrapper's codec")
    has_pad = bool((token_grid == pad_id).any()) if has_padding is None else bool(has_padding)
    if not has_pad:
        return codec.decode_from_codebook_indices(token_grid)
    wavs = []
    ds = codec.downsample_factor
    for row in token_grid:
        keep = ~(row == pad_id).any(-1)
        n_true = int(keep.sum())
        if n_true == 0:
            wavs.append(None)
            continue
        ids = row[keep]
        n_pad = min((-n_true) % length_bucket, token_grid.shape[1] - n_true)
        if n_pad:
            # the last frame repeated, as the JAX package pads a row
            ids = torch.cat([ids, ids[-1:].expand(n_pad, -1)])
        wavs.append(codec.decode_from_codebook_indices(ids[None])[0, : n_true * ds])
    return wavs
