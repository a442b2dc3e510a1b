"""Training runtime, held against the JAX package's `training/trainer.py`:
the LM train step (`TransformerTrainStep`: `_TransformerTrainerBase`'s
`_build_step`, in float32 or bf16 compute), the three LM trainers
(`SemanticTransformerTrainer`, `CoarseTransformerTrainer`,
`FineTransformerTrainer`: data, validation, best-valid and numbered
checkpoints), the SoundStream codec's GAN trainer (`SoundStreamTrainer`),
what they share (`_TrainerBase`: the results folder, the metrics log,
checkpoint cadence and resumption, the micro-batch stack), and the JAX
trainers' defaults.

Data parallelism (`data_parallel=True` in a process that has joined a
process group, `parallel.mesh.init_process_group`): every rank reads the same
whole batch and trains on its rows (`batch_size` must split over the ranks,
as JAX asserts); the random draws over the batch are the whole batch's, cut
to the rank's rows, the quantizers' EMA statistics are summed over the
ranks, and the gradients (the discriminators' too) and the logged losses
are averaged over them before the clip and the update, as JAX's pmean does.
The gradient of a mean over equal shards is the mean of the shards', so
the ranks take the step one process takes on the whole batch wherever each
rank's loss is a mean over the same count (a loss whose count differs per
rank, such as the LM's with `unique_consecutive` dropping repeats, is
weighted per rank, as in JAX). Rank 0 alone writes checkpoints, samples and
the metrics log; every rank waits at a barrier before and after a save and
before a resume. Two limits: every rank loads and decodes the whole batch and
draws each random mask for the whole batch (dropout's is (world * B, H, N, N)
a layer), so those costs grow with the number of ranks; and the ranks equal
one process only on clips that need no random crop (no longer than the
crop), since the dataset's crop generator is shared by the loader's worker
threads, whose order differs between processes.

Tensor parallelism: `TransformerTrainStep(mesh=)` with a mesh that has a
model dimension (`make_mesh(num_data, num_model)`) shards the wrapper's LM
over it (`parallel.tp.apply_tp_sharding`) before its optimizer is built;
each rank then steps on its part, the gradients and the loss averaged over
the data group only and the clip's norm the whole model's. The LM trainers
and the codec's keep data parallelism alone, as the JAX trainers do.
"""
from __future__ import annotations

import json
import random
import re
import time
from pathlib import Path

import numpy as np
import torch

from ..data.dataset import SoundDataset, get_dataloader
from ..device import resolve_device
from ..models.wrappers import (CoarseTransformerWrapper, FineTransformerWrapper,
                               SemanticTransformerWrapper)
from ..parallel import mesh as dp
from ..parallel import tp
from ..utils.audio_io import save_audio
from ..weights import (DISCRIMINATORS, codec_state_dict_from_jax, codec_state_dict_to_jax,
                       lm_state_dict_to_jax, state_dict_from_jax)
from .checkpoint import read_pytree, save_pytree
from .ema import EMA
from .optimizer import clip_by_global_norm_, get_optimizer

__all__ = ["TransformerTrainStep", "SoundStreamTrainer", "SemanticTransformerTrainer",
           "CoarseTransformerTrainer", "FineTransformerTrainer", "checkpoint_num_steps",
           "split_dataset"]


def _bf16_copies(named_params):
    """{name: a bfloat16 copy} of the float32 parameters among (name, p),
    made inside autograd, so the gradient reaches each float32 master
    through its cast (the JAX package's `cast_floats` of the trainable
    parameters). Others pass as they are."""
    return {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
            for n, p in named_params}


class TransformerTrainStep:
    """Trains the transformer of `wrapper` (a Semantic, Coarse or Fine
    wrapper) on `device`; a wav2vec or codec the wrapper holds stays as it
    is. The forgetful masks are drawn from a generator seeded with `seed`.

    One step takes grad_accum_every micro-batches: each gives its loss
    through the wrapper's train path (EOS appended, unique-consecutive, the
    forgetful causal mask), its gradient is scaled by 1 / grad_accum_every
    and summed; then the global-norm clip and one optimizer update. Every
    parameter gets a gradient, zero where the loss does not reach it (the
    text projection of an unconditioned model), as `jax.value_and_grad`
    gives one, so weight decay touches the same parameters as in JAX.

    With bf16_compute each micro-batch's forward runs on bfloat16 copies of
    the transformer's float32 parameters (`torch.func.functional_call`);
    the masters, their gradients and the optimizer state stay float32. The
    norms, the hyper-connections' projection, the rel-pos and position-bias
    MLPs (float32 inputs, so float32 tables from the rounded weights) and
    the loss's log-softmax compute in float32, as in JAX.

    The same generator draws the dropout masks of an LM built with
    attn_dropout or ff_dropout. With a `mesh` (`parallel.mesh.make_mesh`),
    each micro-batch is split over its data ranks, and the gradients and
    the loss are averaged over them before the clip (see the module's
    docstring); a mesh with a model dimension also shards the LM over it,
    in place, the clip summing the cut gradients' squares over the model
    group."""

    def __init__(self, wrapper, *, lr: float = 3e-4, wd: float = 0.0,
                 max_grad_norm: "float | None" = 0.5, grad_accum_every: int = 1,
                 warmup_steps: int = 0, cosine_decay: bool = False,
                 num_train_steps: "int | None" = None, seed: int = 42,
                 bf16_compute: bool = False, mesh=None, device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.wrapper = wrapper.to(self.device)
        cut = tp.apply_tp_sharding(wrapper, mesh) if mesh is not None else {}
        named = [(n, p) for n, p in wrapper.transformer.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.tp = wrapper.transformer.tp
        self.sharded = [cut.get(f"transformer.{n}") is not None for n in self.names]
        self.optimizer, self.scheduler = get_optimizer(
            self.params, lr, wd, warmup_steps=warmup_steps, total_steps=num_train_steps,
            cosine_decay=cosine_decay)
        self.wd = wd
        self.max_grad_norm = max_grad_norm
        self.warmup_steps = warmup_steps
        self.grad_accum_every = grad_accum_every
        self.bf16_compute = bf16_compute
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def loss(self, *inputs, **named_inputs):
        """The wrapper's training loss of one micro-batch, in the step's
        compute type."""
        kwargs = dict(named_inputs, return_loss=True, train=True, generator=self.generator)
        if not self.bf16_compute:
            return self.wrapper(*inputs, **kwargs)
        cast = _bf16_copies((f"transformer.{n}", p) for n, p in zip(self.names, self.params))
        return torch.func.functional_call(self.wrapper, cast, inputs, kwargs)

    def step(self, *inputs, **named_inputs) -> float:
        """One update from the wrapper's batch: tensors, each
        (grad_accum_every * B, ...), positional (the Semantic wrapper's ids;
        the Coarse wrapper's semantic ids and coarse codes; the Fine
        wrapper's coarse and fine codes) or named (raw_wave,
        raw_wave_for_codec, text_embeds). Each is split into grad_accum_every micro-batches
        along its first axis. Returns the mean loss of the micro-batches."""
        accum = self.grad_accum_every
        names = list(named_inputs)
        batches = [x.to(self.device) for x in (*inputs, *named_inputs.values())]
        for x in batches:
            if x.shape[0] % accum:
                raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                                 f"grad_accum_every {accum}")
        for p in self.params:
            p.grad = torch.zeros_like(p)
        losses = []
        micros = [x.reshape(accum, -1, *x.shape[1:]) for x in batches]
        if self.mesh is not None:
            micros = dp.shard_batch(self.mesh, micros, axis=1)
        with dp.data_parallel(self.mesh):
            for micro in zip(*micros):
                npos = len(micro) - len(names)
                loss = self.loss(*micro[:npos], **dict(zip(names, micro[npos:])))
                (loss / accum).backward()
                losses.append(loss.detach())
            loss = torch.stack(losses).mean()
            dp.all_reduce_mean([p.grad for p in self.params] + [loss])
        if self.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params], self.max_grad_norm,
                                 sharded=self.sharded, tp=self.tp)
        self.optimizer.step()
        self.scheduler.step()
        return loss.item()


def checkpoint_num_steps(path) -> int:
    """The step count in a checkpoint's file name (its last number), or 0."""
    nums = re.findall(r"\d+", Path(path).name)
    return int(nums[-1]) if nums else 0


def _discr_path(name: str) -> bool:
    return name.startswith(DISCRIMINATORS)


class _Subset:
    def __init__(self, ds, indices):
        self.ds = ds
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.ds[self.indices[i]]


def split_dataset(ds, valid_frac: float, seed: int = 0):
    """(train, valid): a seeded random split of valid_frac (at least one
    item) held out; (ds, ds) when nothing or everything would be."""
    n = len(ds)
    n_valid = max(1, int(n * valid_frac)) if valid_frac > 0 else 0
    idx = list(range(n))
    random.Random(seed).shuffle(idx)
    if n_valid == 0 or n_valid >= n:
        return ds, ds
    return _Subset(ds, idx[n_valid:]), _Subset(ds, idx[:n_valid])


def _opt_paths(wd: float, max_grad_norm, warmup: int):
    """The indices of Adam's and the schedule's states in the JAX trainers'
    optax chain: [clip], Adam, [decayed weights], the learning rate (its
    state a count only with a warmup schedule)."""
    adam = 1 if max_grad_norm is not None else 0
    sched = adam + (2 if wd > 0 else 1)
    return adam, (sched if warmup > 0 else None)


def _opt_leaves(prefix, opt, sched, names, params, *, wd, max_grad_norm, warmup, to_jax,
                tree=""):
    """The JAX checkpoint leaves of a torch AdamW and its schedule: Adam's
    count, mu and nu (exp_avg, exp_avg_sq; zeros before the first step) by
    the parameters' JAX paths (`to_jax` of {name: tensor}, under `tree`),
    and the schedule's count."""
    adam_i, sched_i = _opt_paths(wd, max_grad_norm, warmup)
    state = [opt.state.get(p, {}) for p in params]
    count = int(state[0]["step"]) if state and "step" in state[0] else 0
    leaves = {f"{prefix}[{adam_i}].count": np.asarray(count, np.int32)}
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        tensors = {n: s[key] if key in s else torch.zeros_like(p)
                   for n, p, s in zip(names, params, state)}
        leaves.update({f"{prefix}[{adam_i}].{moment}{tree}{path}": a
                       for path, a in to_jax(tensors).items()})
    if sched_i is not None:
        leaves[f"{prefix}[{sched_i}].count"] = np.asarray(sched.last_epoch, np.int32)
    return leaves


def _load_opt(arrays, prefix, opt, sched, names, params, *, wd, max_grad_norm, warmup,
              from_jax, tree=""):
    """The inverse of `_opt_leaves`: the optimizer's per-parameter state and
    the schedule's count (and learning rate) from a checkpoint's leaves."""
    adam_i, sched_i = _opt_paths(wd, max_grad_norm, warmup)
    count = int(arrays[f"{prefix}[{adam_i}].count"])
    moments = {}
    for moment in ("mu", "nu"):
        head = f"{prefix}[{adam_i}].{moment}{tree}"
        moments[moment] = from_jax(
            {k[len(head):]: a for k, a in arrays.items() if k.startswith(head)})
    for n, p in zip(names, params):
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": moments["mu"][n].to(p.device, p.dtype),
                        "exp_avg_sq": moments["nu"][n].to(p.device, p.dtype)}
    if sched_i is not None:
        sched.last_epoch = int(arrays[f"{prefix}[{sched_i}].count"])
        for group, base, fn in zip(opt.param_groups, sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * fn(sched.last_epoch)
        sched._last_lr = [group["lr"] for group in opt.param_groups]


def _generator_state(generator) -> str:
    return generator.get_state().cpu().numpy().tobytes().hex()


def _set_generator_state(generator, hexstate: str):
    generator.set_state(torch.frombuffer(bytearray.fromhex(hexstate), dtype=torch.uint8))


class _MetricWriter:
    """Appends each step's metrics to results_folder/metrics.jsonl."""

    def __init__(self, folder: Path, use_wandb: bool = False):
        if use_wandb:
            raise NotImplementedError("wandb tracking is not ported; the metrics are written to "
                                      "results_folder/metrics.jsonl")
        self.path = Path(folder) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, **metrics):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "time": time.time(), **metrics}) + "\n")


class _TrainerBase:
    """The results folder, the metrics log, the step count and the
    checkpoint cadence, shared by the trainers."""

    def __init__(self, *, results_folder, num_train_steps: int, batch_size: int,
                 grad_accum_every: int = 1, save_results_every: int = 100,
                 save_model_every: int = 1000, use_wandb_tracking: bool = False,
                 data_parallel: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.mesh = dp.make_mesh() if data_parallel and torch.distributed.is_initialized() \
            else None
        if self.mesh is not None and batch_size % self.mesh.size():
            raise ValueError(f"batch_size {batch_size} does not split over the "
                             f"{self.mesh.size()} data-parallel ranks")
        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.num_train_steps = num_train_steps
        self.batch_size = batch_size
        self.grad_accum_every = grad_accum_every
        self.save_results_every = save_results_every
        self.save_model_every = save_model_every
        self.steps = 0
        self.metrics = _MetricWriter(self.results_folder, use_wandb_tracking)

    @property
    def is_main(self) -> bool:
        return dp.is_main()

    def _log(self, **metrics):
        if self.is_main:
            self.metrics.log(self.steps, **metrics)

    def _save_numbered(self, path):
        """Save on rank 0, every rank waiting before and after."""
        dp.barrier()
        if self.is_main:
            self.save(path)
        dp.barrier()

    def resume_latest(self, pattern: str = "*.ckpt.npz") -> bool:
        """Load the checkpoint in results_folder with the most steps (not a
        `.best.` one); False if there is none. Every rank waits for the
        others first, so what rank 0 saved is there."""
        dp.barrier()
        ckpts = sorted((p for p in self.results_folder.glob(pattern) if ".best." not in p.name),
                       key=checkpoint_num_steps)
        if not ckpts:
            return False
        self.load(ckpts[-1])
        if self.is_main:
            print(f"resumed from {ckpts[-1]} at step {self.steps}")
        return True

    def _stack_accum(self, dl_iter):
        """grad_accum_every batches from dl_iter, right-padded to the longest
        and stacked: (accum, B, T) numpy, or a tuple of those (a list of
        strings for a text field, flattened) when the dataset gives
        tuples."""
        batches = [next(dl_iter) for _ in range(self.grad_accum_every)]

        def stack(col):
            if isinstance(col[0], list):
                return [x for c in col for x in c]
            width = max(c.shape[-1] for c in col)
            return np.stack([np.pad(c, ((0, 0), (0, width - c.shape[-1]))) for c in col])

        if isinstance(batches[0], tuple):
            return tuple(stack([b[i] for b in batches]) for i in range(len(batches[0])))
        return stack(batches)

    def close(self):
        """Stop the data loaders' worker threads."""
        self.dl_iter.stop()
        self.valid_dl_iter.stop()

    def train(self):
        while self.steps < self.num_train_steps:
            t0 = time.perf_counter()
            logs = self.train_step()
            logs["step_s"] = time.perf_counter() - t0
            if self.is_main:
                print(f"{self.steps}: " + " | ".join(f"{k} {v:.4f}" for k, v in logs.items()))
        if self.is_main:
            print("training complete")


class SoundStreamTrainer(_TrainerBase):
    """The GAN trainer of the SoundStream codec, held against the JAX
    package's `SoundStreamTrainer`. A step: the generator's step over
    grad_accum_every micro-batches of the data (the quantizers train: the
    EMA state of one micro-batch feeds the next, so N micro-batches make N
    updates in order), its gradient 1 / N of each, clipped, one Adam update,
    then the model's EMA; then, with train_discriminators, the
    discriminators' step on the same batch (the quantizers in eval, their
    state untouched), with the gradient penalty when steps is a multiple of
    apply_grad_penalty_every. The random draws of training (kmeans,
    dead-code candidates, quantizer dropout) come from one CPU
    torch.Generator seeded with `seed`, which checkpoints keep.

    With bf16_compute the G step and the D step without the penalty run on
    bfloat16 copies of their float32 parameters and a bfloat16 batch, as
    JAX's do; the masters, the optimizer and EMA state and the quantizers'
    buffers stay float32 (the EMA statistics are summed in float32 from the
    detached input and written into the float32 buffers), the loss terms
    are float32, and the D step with the gradient penalty (a second
    derivative) runs in float32.

    Checkpoints hold the JAX trainer's leaves by its names (the model under
    `['model']`, the two Adam states, the EMA), so each package loads the
    other's."""

    def __init__(self, soundstream, *, num_train_steps: int, batch_size: int, folder=None,
                 dataset=None, val_dataset=None, data_max_length: "int | None" = None,
                 data_max_length_seconds: "float | None" = None, lr: float = 2e-4,
                 grad_accum_every: int = 4, wd: float = 0.0, warmup_steps: int = 1000,
                 scheduler_cosine_decay: bool = False, discr_warmup_steps: "int | None" = None,
                 max_grad_norm: "float | None" = 0.5,
                 discr_max_grad_norm: "float | None" = None, apply_grad_penalty_every: int = 4,
                 ema_beta: float = 0.995, ema_update_after_step: int = 500,
                 ema_update_every: int = 10, save_results_every: int = 100,
                 save_model_every: int = 1000, results_folder="./results", use_ema: bool = True,
                 use_wandb_tracking: bool = False, data_parallel: bool = True, seed: int = 42,
                 valid_frac: float = 0.05, bf16_compute: bool = False,
                 train_discriminators: bool = True, device="cuda"):
        super().__init__(results_folder=results_folder, num_train_steps=num_train_steps,
                         batch_size=batch_size, grad_accum_every=grad_accum_every,
                         save_results_every=save_results_every,
                         save_model_every=save_model_every,
                         use_wandb_tracking=use_wandb_tracking, data_parallel=data_parallel,
                         device=device)
        self.model = soundstream.to(self.device)
        self.bf16_compute = bf16_compute
        self.apply_grad_penalty_every = apply_grad_penalty_every
        self.train_discriminators = train_discriminators
        if data_max_length_seconds is not None:
            if data_max_length is not None:
                raise ValueError("give data_max_length or data_max_length_seconds, not both")
            data_max_length = int(data_max_length_seconds * soundstream.target_sample_hz)
        if dataset is None:
            if folder is None:
                raise ValueError("pass folder= or dataset=")
            dataset = SoundDataset(folder, target_sample_hz=soundstream.target_sample_hz,
                                   max_length=data_max_length,
                                   seq_len_multiple_of=soundstream.seq_len_multiple_of,
                                   seed=seed)
        if val_dataset is not None:
            self.ds, self.valid_ds = dataset, val_dataset
        else:
            self.ds, self.valid_ds = split_dataset(dataset, valid_frac, seed)
        self.dl_iter = get_dataloader(self.ds, batch_size=batch_size)
        self.valid_dl_iter = get_dataloader(self.valid_ds, batch_size=batch_size)

        named = list(self.model.named_parameters())
        self.gen_names = [n for n, _ in named if not _discr_path(n)]
        self.discr_names = [n for n, _ in named if _discr_path(n)]
        params = dict(named)
        self.gen_params = [params[n] for n in self.gen_names]
        self.discr_params = [params[n] for n in self.discr_names]
        self.max_grad_norm = max_grad_norm
        self.discr_max_grad_norm = discr_max_grad_norm if discr_max_grad_norm is not None \
            else max_grad_norm
        self.wd = wd
        self.gen_opt, self.gen_sched = get_optimizer(
            self.gen_params, lr, wd, warmup_steps=warmup_steps, total_steps=num_train_steps,
            cosine_decay=scheduler_cosine_decay)
        self.discr_warmup_steps = discr_warmup_steps if discr_warmup_steps is not None \
            else warmup_steps
        self.warmup_steps = warmup_steps
        self.discr_opt, self.discr_sched = get_optimizer(
            self.discr_params, lr, wd, warmup_steps=self.discr_warmup_steps,
            total_steps=num_train_steps, cosine_decay=scheduler_cosine_decay)
        self.ema = EMA(self.model, beta=ema_beta, update_after_step=ema_update_after_step,
                       update_every=ema_update_every) if use_ema else None
        self.generator = torch.Generator().manual_seed(seed)

    # -- the two steps --------------------------------------------------------
    def _call(self, names, params, bf16: bool, wave, **kwargs):
        """The model on wave; with bf16, on bfloat16 copies of `params` and
        of wave."""
        if not bf16:
            return self.model(wave, **kwargs)
        return torch.func.functional_call(self.model, _bf16_copies(zip(names, params)),
                                          (wave.to(torch.bfloat16),), kwargs)

    def _accumulate(self, params, losses_of_micro, waves):
        """Sum 1 / N of each micro-batch's gradient of `params` (zero where
        the loss does not reach one) into their .grad, averaged over the
        data-parallel ranks; returns the mean (loss, extra) of
        losses_of_micro(wave) = (loss, extra tensor or None), averaged over
        the ranks too. Call inside the step's `data_parallel` scope."""
        accum = waves.shape[0]
        grads = [torch.zeros_like(p) for p in params]
        outs = []
        for wave in waves:
            loss, extra = losses_of_micro(wave)
            for acc, g in zip(grads, torch.autograd.grad(loss, params, allow_unused=True)):
                if g is not None:
                    acc.add_(g * (1.0 / accum))
            outs.append((loss.detach(), extra))
        loss = torch.stack([o[0] for o in outs]).mean()
        extra = None if outs[0][1] is None else torch.stack([o[1] for o in outs]).mean(0)
        dp.all_reduce_mean(grads + [loss] + ([] if extra is None else [extra]))
        for p, g in zip(params, grads):
            p.grad = g
        return loss, extra

    def _shard(self, waves):
        """This rank's rows of waves (accum, B, T)."""
        return waves if self.mesh is None else dp.shard_batch(self.mesh, waves, axis=1)

    def g_step(self, waves):
        """The generator's step on waves (accum, B, T) on the card: returns
        (mean loss, mean breakdown), both tensors. Under data parallelism
        waves is the whole batch and this rank trains on its rows."""
        def micro(wave):
            total, breakdown = self._call(self.gen_names, self.gen_params, self.bf16_compute,
                                          wave, train=True, generator=self.generator,
                                          return_loss_breakdown=True)
            return total, torch.stack(breakdown).detach()

        with dp.data_parallel(self.mesh):
            loss, breakdown = self._accumulate(self.gen_params, micro, self._shard(waves))
        if self.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.gen_params], self.max_grad_norm)
        self.gen_opt.step()
        self.gen_sched.step()
        if self.ema is not None:
            self.ema.update(self.model)
        return loss, breakdown

    def d_step(self, waves, apply_grad_penalty: bool):
        """The discriminators' step on waves (accum, B, T): the mean loss.
        With bf16_compute it runs in bfloat16 unless it applies the
        penalty."""
        bf16 = self.bf16_compute and not apply_grad_penalty

        def micro(wave):
            return self._call(self.discr_names, self.discr_params, bf16, wave,
                              return_discr_loss=True,
                              apply_grad_penalty=apply_grad_penalty), None

        with dp.data_parallel(self.mesh):
            loss, _ = self._accumulate(self.discr_params, micro, self._shard(waves))
        if self.discr_max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.discr_params], self.discr_max_grad_norm)
        self.discr_opt.step()
        self.discr_sched.step()
        return loss

    def train_step(self):
        """One step on the next grad_accum_every batches: the logs."""
        waves = torch.from_numpy(self._stack_accum(self.dl_iter)).to(self.device)
        g_loss, breakdown = self.g_step(waves)
        d_loss = 0.0
        if self.train_discriminators:
            apply_gp = self.steps % self.apply_grad_penalty_every == 0
            d_loss = float(self.d_step(waves, apply_gp))
        recon, mel, mstft, sisnr, adv, feat, commit = breakdown.tolist()
        logs = dict(loss=float(g_loss), recon_loss=recon, multi_spectral=mel, multi_stft=mstft,
                    si_snr_loss=sisnr, adversarial=adv, feature_loss=feat, commit=commit,
                    discr_loss=d_loss)
        self._log(**logs)
        self.steps += 1
        if self.is_main and self.steps % self.save_results_every == 0:
            self._dump_samples()
        if self.steps % self.save_model_every == 0:
            self._save_numbered(self.results_folder / f"soundstream.{self.steps}.ckpt.npz")
        return logs

    @torch.no_grad()
    def _dump_samples(self):
        """The reconstruction of one held-out clip by the model and by its
        EMA shadow, as WAV files in results_folder."""
        wave = torch.from_numpy(next(self.valid_dl_iter)[:1]).to(self.device)
        models = [("", self.model)] + ([("ema.", self.ema.shadow)] if self.ema else [])
        for prefix, m in models:
            recon = m(wave, return_recons_only=True)
            save_audio(self.results_folder / f"sample.{prefix}{self.steps}.wav",
                       recon[0].float().cpu().numpy(), m.target_sample_hz)

    # -- checkpoints ---------------------------------------------------------
    def _state_leaves(self):
        buffers = [n for n, _ in self.model.named_buffers()]
        leaves = {f"['model']{k}": a for k, a in
                  codec_state_dict_to_jax(self.model.state_dict(), buffers).items()}
        kw = dict(wd=self.wd, to_jax=codec_state_dict_to_jax)
        leaves.update(_opt_leaves("['gen_opt']", self.gen_opt, self.gen_sched, self.gen_names,
                                  self.gen_params, max_grad_norm=self.max_grad_norm,
                                  warmup=self.warmup_steps, **kw))
        leaves.update(_opt_leaves("['discr_opt']", self.discr_opt, self.discr_sched,
                                  self.discr_names, self.discr_params,
                                  max_grad_norm=self.discr_max_grad_norm,
                                  warmup=self.discr_warmup_steps, **kw))
        if self.ema is not None:
            leaves.update({f"['ema'].shadow{k}": a for k, a in codec_state_dict_to_jax(
                self.ema.shadow.state_dict(), buffers).items()})
            leaves["['ema'].step"] = np.asarray(self.ema.step, np.int32)
        return leaves

    def save(self, path):
        """The trainer's state in the JAX trainer's checkpoint format, with
        the model's config, the step count and the generator's state."""
        save_pytree(path, self._state_leaves(), extra_meta={
            "steps": self.steps, "kind": "SoundStreamTrainer", "config": self.model.config,
            "torch_generator_state": _generator_state(self.generator)})
        print(f"saved checkpoint to {path}")

    def load(self, path):
        """Load a checkpoint of either package's trainer; the step count
        becomes the file name's plus one, as in JAX."""
        meta, arrays = read_pytree(path)
        want = set(self._state_leaves())
        if set(arrays) != want:
            raise ValueError(f"checkpoint structure mismatch: missing "
                             f"{sorted(want - set(arrays))[:5]} extra "
                             f"{sorted(set(arrays) - want)[:5]}")

        def under(prefix):
            return {k[len(prefix):]: a for k, a in arrays.items() if k.startswith(prefix)}

        self.model.load_state_dict(codec_state_dict_from_jax(under("['model']")))
        kw = dict(wd=self.wd, from_jax=codec_state_dict_from_jax)
        _load_opt(arrays, "['gen_opt']", self.gen_opt, self.gen_sched, self.gen_names,
                  self.gen_params, max_grad_norm=self.max_grad_norm, warmup=self.warmup_steps,
                  **kw)
        _load_opt(arrays, "['discr_opt']", self.discr_opt, self.discr_sched, self.discr_names,
                  self.discr_params, max_grad_norm=self.discr_max_grad_norm,
                  warmup=self.discr_warmup_steps, **kw)
        if self.ema is not None:
            self.ema.shadow.load_state_dict(codec_state_dict_from_jax(under("['ema'].shadow")))
            self.ema.step = int(arrays["['ema'].step"])
        if "torch_generator_state" in meta:
            _set_generator_state(self.generator, meta["torch_generator_state"])
        self.steps = checkpoint_num_steps(path) + 1


class _TransformerTrainerBase(_TrainerBase):
    """The LM trainers' skeleton, held against the JAX package's
    `_TransformerTrainerBase`: a dataset from `folder` (or `dataset`),
    split by valid_frac; each step grad_accum_every batches through
    `TransformerTrainStep` (the dataset's fields become the wrapper's
    `wrapper_field_order` keywords); every save_results_every steps the
    valid loss (the mean of grad_accum_every held-out batches, in float32,
    without the forgetful mask) and, when it improves,
    `<name>.transformer.best.ckpt.npz`; every save_model_every steps
    `<name>.transformer.<steps>.ckpt.npz`. Checkpoints hold the JAX
    trainer's leaves by its names (`['model']` the transformer, `['opt']`
    the optax chain's Adam and schedule states) with `steps`, `kind`,
    `best_valid` and the transformer's `config` in the meta, so each package
    resumes the other's. With data_parallel in a process group, the step
    is split over the ranks (`TransformerTrainStep`'s mesh); rank 0 alone
    writes the checkpoints and the log."""

    wrapper_field_order = ("raw_wave",)

    def __init__(self, wrapper, *, num_train_steps: int, batch_size: int, dataset=None,
                 folder=None, lr: float = 3e-4, wd: float = 0.0,
                 max_grad_norm: "float | None" = 0.5, grad_accum_every: int = 1,
                 warmup_steps: int = 0, cosine_decay: bool = False,
                 save_results_every: int = 100, save_model_every: int = 1000,
                 results_folder="./results", use_wandb_tracking: bool = False,
                 data_parallel: bool = True, seed: int = 42, valid_frac: float = 0.05,
                 bf16_compute: bool = False, dataset_kwargs: "dict | None" = None,
                 name: str = "lm", device="cuda"):
        super().__init__(results_folder=results_folder, num_train_steps=num_train_steps,
                         batch_size=batch_size, grad_accum_every=grad_accum_every,
                         save_results_every=save_results_every,
                         save_model_every=save_model_every,
                         use_wandb_tracking=use_wandb_tracking, data_parallel=data_parallel,
                         device=device)
        self.name = name
        self.best_valid = float("inf")
        self.step_fn = TransformerTrainStep(
            wrapper, lr=lr, wd=wd, max_grad_norm=max_grad_norm,
            grad_accum_every=grad_accum_every, warmup_steps=warmup_steps,
            cosine_decay=cosine_decay, num_train_steps=num_train_steps, seed=seed,
            bf16_compute=bf16_compute, mesh=self.mesh, device=self.device)
        self.wrapper = self.step_fn.wrapper
        if dataset is None:
            if folder is None:
                raise ValueError("pass folder= or dataset=")
            dataset = self._build_dataset(folder, **(dataset_kwargs or {}))
        self.ds, self.valid_ds = split_dataset(dataset, valid_frac, seed)
        self.dl_iter = get_dataloader(self.ds, batch_size=batch_size)
        self.valid_dl_iter = get_dataloader(self.valid_ds, batch_size=batch_size)

    def _build_dataset(self, folder, **kwargs):
        raise NotImplementedError

    def _batch_to_kwargs(self, batch):
        """The dataset's fields as the wrapper's keywords: a field of strings
        as `text_embeds`, the T5 embeddings of the whole list at once (the
        frozen encoder, on the card), the others in wrapper_field_order as
        tensors."""
        fields = batch if isinstance(batch, tuple) else (batch,)
        kwargs = {}
        waves = iter(self.wrapper_field_order)
        for f in fields:
            if isinstance(f, list) and f and isinstance(f[0], str):
                kwargs["text_embeds"] = self.wrapper.transformer.embed_text(f)
            else:
                kwargs[next(waves)] = torch.as_tensor(f)
        return kwargs

    def train_step(self):
        """One update on the next grad_accum_every batches: the logs."""
        stacked = self._stack_accum(self.dl_iter)
        kwargs = self._batch_to_kwargs(stacked)
        kwargs = {k: v if k == "text_embeds" else v.reshape(-1, *v.shape[2:])
                  for k, v in kwargs.items()}
        logs = {"loss": self.step_fn.step(**kwargs)}
        self._log(**logs)
        self.steps += 1
        if self.is_main and self.steps % self.save_results_every == 0:
            vloss = self.valid_loss()
            logs["valid_loss"] = vloss
            self._log(valid_loss=vloss)
            print(f"{self.steps}: valid loss {vloss:.4f}")
            if vloss < self.best_valid:
                self.best_valid = vloss
                self.save(self.results_folder / f"{self.name}.transformer.best.ckpt.npz")
        if self.steps % self.save_model_every == 0:
            self._save_numbered(
                self.results_folder / f"{self.name}.transformer.{self.steps}.ckpt.npz")
        return logs

    @torch.no_grad()
    def valid_loss(self) -> float:
        """The mean loss of grad_accum_every held-out batches, float32
        weights, no forgetful mask (train=False)."""
        losses = []
        for _ in range(self.grad_accum_every):
            kwargs = {k: v.to(self.device)
                      for k, v in self._batch_to_kwargs(next(self.valid_dl_iter)).items()}
            losses.append(float(self.wrapper(**kwargs, return_loss=True, train=False)))
        return float(np.mean(losses))

    # -- checkpoints ---------------------------------------------------------
    def _state_leaves(self):
        transformer = self.wrapper.transformer
        leaves = {f"['model']{k}": a
                  for k, a in lm_state_dict_to_jax(transformer.state_dict()).items()}
        st = self.step_fn
        leaves.update(_opt_leaves("['opt']", st.optimizer, st.scheduler, st.names, st.params,
                                  wd=st.wd, max_grad_norm=st.max_grad_norm,
                                  warmup=st.warmup_steps, to_jax=lm_state_dict_to_jax,
                                  tree=".transformer"))
        return leaves

    def save(self, path):
        """The trainer's state in the JAX trainer's checkpoint format, with
        the step count, the best valid loss, the transformer's config and
        the mask generator's state."""
        save_pytree(path, self._state_leaves(), extra_meta={
            "steps": self.steps, "kind": self.name, "best_valid": self.best_valid,
            "config": self.wrapper.transformer.config,
            "torch_generator_state": _generator_state(self.step_fn.generator)})
        print(f"saved checkpoint to {path}")

    def load(self, path):
        """Load a checkpoint of either package's trainer: the step count is
        the file name's plus one (a `.best.` file's from its meta), and the
        best valid loss comes from the meta, as in JAX."""
        meta, arrays = read_pytree(path)
        want = set(self._state_leaves())
        if set(arrays) != want:
            raise ValueError(f"checkpoint structure mismatch: missing "
                             f"{sorted(want - set(arrays))[:5]} extra "
                             f"{sorted(set(arrays) - want)[:5]}")
        head = "['model']"
        self.wrapper.transformer.load_state_dict(state_dict_from_jax(
            {k[len(head):]: a for k, a in arrays.items() if k.startswith(head)}))
        st = self.step_fn
        _load_opt(arrays, "['opt']", st.optimizer, st.scheduler, st.names, st.params,
                  wd=st.wd, max_grad_norm=st.max_grad_norm, warmup=st.warmup_steps,
                  from_jax=state_dict_from_jax, tree=".transformer")
        if "torch_generator_state" in meta:
            _set_generator_state(st.generator, meta["torch_generator_state"])
        self.steps = checkpoint_num_steps(path) + 1
        self.best_valid = float(meta.get("best_valid", float("inf")))
        if ".best." in Path(path).name and "steps" in meta:
            self.steps = int(meta["steps"]) + 1  # no step count in the name

    def generate(self, *args, **kwargs):
        return self.wrapper.generate(*args, **kwargs)


class SemanticTransformerTrainer(_TransformerTrainerBase):
    """Trains a SemanticTransformer on the wav2vec's ids of audio from
    `folder`, at the wav2vec's rate and multiple."""

    def __init__(self, transformer, wav2vec=None, *, data_max_length=None,
                 data_max_length_seconds=None, folder=None, dataset=None, **kwargs):
        wrapper = SemanticTransformerWrapper(transformer=transformer, wav2vec=wav2vec)
        self._wav2vec = wav2vec
        if data_max_length_seconds is not None:
            data_max_length = int(data_max_length_seconds * wav2vec.target_sample_hz)
        self._data_max_length = data_max_length
        super().__init__(wrapper, folder=folder, dataset=dataset, name="semantic", **kwargs)

    def _build_dataset(self, folder, **kwargs):
        return SoundDataset(folder, target_sample_hz=self._wav2vec.target_sample_hz,
                            max_length=self._data_max_length,
                            seq_len_multiple_of=self._wav2vec.seq_len_multiple_of, **kwargs)


class CoarseTransformerTrainer(_TransformerTrainerBase):
    """Trains a CoarseTransformer: each clip is read at the wav2vec's rate
    (its semantic ids) and at the codec's (its coarse codes)."""

    wrapper_field_order = ("raw_wave", "raw_wave_for_codec")

    def __init__(self, transformer, codec=None, wav2vec=None, *, data_max_length=None,
                 data_max_length_seconds=None, folder=None, dataset=None, **kwargs):
        wrapper = CoarseTransformerWrapper(transformer=transformer, codec=codec,
                                           wav2vec=wav2vec)
        self._wav2vec, self._codec = wav2vec, codec
        if data_max_length_seconds is not None:
            data_max_length = tuple(int(data_max_length_seconds * hz) for hz in
                                    (wav2vec.target_sample_hz, codec.target_sample_hz))
        self._data_max_length = data_max_length
        super().__init__(wrapper, folder=folder, dataset=dataset, name="coarse", **kwargs)

    def _build_dataset(self, folder, **kwargs):
        max_len = self._data_max_length
        if isinstance(max_len, tuple):
            max_len = max(max_len)
        return SoundDataset(
            folder, target_sample_hz=(self._wav2vec.target_sample_hz,
                                      self._codec.target_sample_hz),
            max_length=max_len, seq_len_multiple_of=(self._wav2vec.seq_len_multiple_of,
                                                     self._codec.seq_len_multiple_of),
            **kwargs)


class FineTransformerTrainer(_TransformerTrainerBase):
    """Trains a FineTransformer on the codec's codes of audio from
    `folder`, at the codec's rate and multiple."""

    def __init__(self, transformer, codec=None, *, data_max_length=None,
                 data_max_length_seconds=None, folder=None, dataset=None, **kwargs):
        wrapper = FineTransformerWrapper(transformer=transformer, codec=codec)
        self._codec = codec
        if data_max_length_seconds is not None:
            data_max_length = int(data_max_length_seconds * codec.target_sample_hz)
        self._data_max_length = data_max_length
        super().__init__(wrapper, folder=folder, dataset=dataset, name="fine", **kwargs)

    def _build_dataset(self, folder, **kwargs):
        return SoundDataset(folder, target_sample_hz=self._codec.target_sample_hz,
                            max_length=self._data_max_length,
                            seq_len_multiple_of=self._codec.seq_len_multiple_of, **kwargs)
