"""Training runtime, held against the JAX package's `training/trainer.py`:
the LM train step (`_TransformerTrainerBase`'s `_build_step` and the update
part of its `train_step`) and the SoundStream codec's GAN trainer
(`SoundStreamTrainer`), with what they share (`_TrainerBase`: the results
folder, the metrics log, checkpoint cadence and resumption, the
micro-batch stack), and the JAX trainers' defaults.

One card: `data_parallel` is accepted and has no effect. The LM trainers'
dataset, wav2vec tokenisation, validation and checkpoints are not ported
yet.
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
from ..utils.audio_io import save_audio
from ..weights import DISCRIMINATORS, codec_state_dict_from_jax, codec_state_dict_to_jax
from .checkpoint import read_pytree, save_pytree
from .ema import EMA
from .optimizer import clip_by_global_norm_, get_optimizer

__all__ = ["TransformerTrainStep", "SoundStreamTrainer", "checkpoint_num_steps",
           "split_dataset"]


class TransformerTrainStep:
    """Trains the transformer of `wrapper` (a Semantic, Coarse or Fine
    wrapper) on `device`; a codec the wrapper holds stays as it is. The
    forgetful masks are drawn from a generator seeded with `seed`.

    One step takes grad_accum_every micro-batches: each gives its loss
    through the wrapper's train path (EOS appended, unique-consecutive, the
    forgetful causal mask), its gradient is scaled by 1 / grad_accum_every
    and summed; then the global-norm clip and one optimizer update. Every
    parameter gets a gradient, zero where the loss does not reach it (the
    text projection of an unconditioned model), as `jax.value_and_grad`
    gives one, so weight decay touches the same parameters as in JAX."""

    def __init__(self, wrapper, *, lr: float = 3e-4, wd: float = 0.0,
                 max_grad_norm: "float | None" = 0.5, grad_accum_every: int = 1,
                 warmup_steps: int = 0, cosine_decay: bool = False,
                 num_train_steps: "int | None" = None, seed: int = 42,
                 device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)
        self.wrapper = wrapper.to(self.device)
        self.params = [p for p in wrapper.transformer.parameters() if p.requires_grad]
        self.optimizer, self.scheduler = get_optimizer(
            self.params, lr, wd, warmup_steps=warmup_steps, total_steps=num_train_steps,
            cosine_decay=cosine_decay)
        self.max_grad_norm = max_grad_norm
        self.grad_accum_every = grad_accum_every
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def step(self, *token_ids) -> float:
        """One update from the wrapper's batch: one or more id tensors, each
        (grad_accum_every * B, ...) (the Semantic wrapper's ids; the Coarse
        wrapper's semantic ids and coarse codes; the Fine wrapper's coarse
        and fine codes). Each is split into grad_accum_every micro-batches
        along its first axis. Returns the mean loss of the micro-batches."""
        accum = self.grad_accum_every
        batches = [ids.to(self.device) for ids in token_ids]
        for ids in batches:
            if ids.shape[0] % accum:
                raise ValueError(f"batch {ids.shape[0]} is not a multiple of "
                                 f"grad_accum_every {accum}")
        for p in self.params:
            p.grad = torch.zeros_like(p)
        losses = []
        for micro in zip(*(ids.reshape(accum, -1, *ids.shape[1:]) for ids in batches)):
            loss = self.wrapper(*micro, return_loss=True, train=True, generator=self.generator)
            (loss / accum).backward()
            losses.append(loss.detach())
        if self.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.params], self.max_grad_norm)
        self.optimizer.step()
        self.scheduler.step()
        return torch.stack(losses).mean().item()


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
                 device="cuda"):
        self.device = resolve_device(device)
        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.num_train_steps = num_train_steps
        self.batch_size = batch_size
        self.grad_accum_every = grad_accum_every
        self.save_results_every = save_results_every
        self.save_model_every = save_model_every
        self.steps = 0
        self.metrics = _MetricWriter(self.results_folder, use_wandb_tracking)

    def resume_latest(self, pattern: str = "*.ckpt.npz") -> bool:
        """Load the checkpoint in results_folder with the most steps (not a
        `.best.` one); False if there is none."""
        ckpts = sorted((p for p in self.results_folder.glob(pattern) if ".best." not in p.name),
                       key=checkpoint_num_steps)
        if not ckpts:
            return False
        self.load(ckpts[-1])
        print(f"resumed from {ckpts[-1]} at step {self.steps}")
        return True

    def _stack_accum(self, dl_iter):
        """grad_accum_every batches from dl_iter, right-padded to the longest
        and stacked: (accum, B, T) numpy."""
        batches = [next(dl_iter) for _ in range(self.grad_accum_every)]
        width = max(b.shape[-1] for b in batches)
        return np.stack([np.pad(b, ((0, 0), (0, width - b.shape[-1]))) for b in batches])

    def train(self):
        while self.steps < self.num_train_steps:
            t0 = time.perf_counter()
            logs = self.train_step()
            logs["step_s"] = time.perf_counter() - t0
            print(f"{self.steps}: " + " | ".join(f"{k} {v:.4f}" for k, v in logs.items()))
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

    Checkpoints hold the JAX trainer's leaves by its names (the model under
    `['model']`, the two Adam states, the EMA), so each package loads the
    other's. bf16_compute is not ported yet."""

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
        if bf16_compute:
            raise NotImplementedError("bf16_compute is not ported yet (ROADMAP.md, Queue 1: "
                                      "bf16 compute); train in float32")
        super().__init__(results_folder=results_folder, num_train_steps=num_train_steps,
                         batch_size=batch_size, grad_accum_every=grad_accum_every,
                         save_results_every=save_results_every,
                         save_model_every=save_model_every,
                         use_wandb_tracking=use_wandb_tracking, device=device)
        self.model = soundstream.to(self.device)
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
    def _accumulate(self, params, losses_of_micro, waves):
        """Sum 1 / N of each micro-batch's gradient of `params` (zero where
        the loss does not reach one) into their .grad; returns the outputs
        of losses_of_micro(wave) = (loss, extra)."""
        accum = waves.shape[0]
        grads = [torch.zeros_like(p) for p in params]
        outs = []
        for wave in waves:
            loss, extra = losses_of_micro(wave)
            for acc, g in zip(grads, torch.autograd.grad(loss, params, allow_unused=True)):
                if g is not None:
                    acc.add_(g * (1.0 / accum))
            outs.append((loss.detach(), extra))
        for p, g in zip(params, grads):
            p.grad = g
        return outs

    def g_step(self, waves):
        """The generator's step on waves (accum, B, T) on the card: returns
        (mean loss, mean breakdown), both tensors."""
        def micro(wave):
            total, breakdown = self.model(wave, train=True, generator=self.generator,
                                          return_loss_breakdown=True)
            return total, torch.stack(breakdown).detach()

        outs = self._accumulate(self.gen_params, micro, waves)
        if self.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.gen_params], self.max_grad_norm)
        self.gen_opt.step()
        self.gen_sched.step()
        if self.ema is not None:
            self.ema.update(self.model)
        return (torch.stack([o[0] for o in outs]).mean(),
                torch.stack([o[1] for o in outs]).mean(0))

    def d_step(self, waves, apply_grad_penalty: bool):
        """The discriminators' step on waves (accum, B, T): the mean loss."""
        def micro(wave):
            return self.model(wave, return_discr_loss=True,
                              apply_grad_penalty=apply_grad_penalty), None

        outs = self._accumulate(self.discr_params, micro, waves)
        if self.discr_max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in self.discr_params], self.discr_max_grad_norm)
        self.discr_opt.step()
        self.discr_sched.step()
        return torch.stack([o[0] for o in outs]).mean()

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
        self.metrics.log(self.steps, **logs)
        self.steps += 1
        if self.steps % self.save_results_every == 0:
            self._dump_samples()
        if self.steps % self.save_model_every == 0:
            self.save(self.results_folder / f"soundstream.{self.steps}.ckpt.npz")
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
    def _opt_paths(self, wd: float, max_grad_norm, warmup: int):
        """The indices of Adam's and the schedule's states in the JAX
        trainer's optax chain: [clip], Adam, [decayed weights], the
        learning rate (its state a count only with a warmup schedule)."""
        adam = 1 if max_grad_norm is not None else 0
        sched = adam + (2 if wd > 0 else 1)
        return adam, (sched if warmup > 0 else None)

    def _opt_leaves(self, prefix, opt, sched, names, params, max_grad_norm, warmup):
        adam_i, sched_i = self._opt_paths(self.wd, max_grad_norm, warmup)
        state = [opt.state.get(p, {}) for p in params]
        count = int(state[0]["step"]) if state and "step" in state[0] else 0
        leaves = {f"{prefix}[{adam_i}].count": np.asarray(count, np.int32)}
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            tensors = {n: s[key] if key in s else torch.zeros_like(p)
                       for n, p, s in zip(names, params, state)}
            leaves.update({f"{prefix}[{adam_i}].{moment}{path}": a
                           for path, a in codec_state_dict_to_jax(tensors).items()})
        if sched_i is not None:
            leaves[f"{prefix}[{sched_i}].count"] = np.asarray(sched.last_epoch, np.int32)
        return leaves

    def _load_opt(self, arrays, prefix, opt, sched, names, params, max_grad_norm, warmup):
        adam_i, sched_i = self._opt_paths(self.wd, max_grad_norm, warmup)
        count = int(arrays[f"{prefix}[{adam_i}].count"])
        moments = {}
        for moment in ("mu", "nu"):
            head = f"{prefix}[{adam_i}].{moment}"
            moments[moment] = codec_state_dict_from_jax(
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

    def _state_leaves(self):
        buffers = [n for n, _ in self.model.named_buffers()]
        leaves = {f"['model']{k}": a for k, a in
                  codec_state_dict_to_jax(self.model.state_dict(), buffers).items()}
        leaves.update(self._opt_leaves("['gen_opt']", self.gen_opt, self.gen_sched,
                                       self.gen_names, self.gen_params, self.max_grad_norm,
                                       self.warmup_steps))
        leaves.update(self._opt_leaves("['discr_opt']", self.discr_opt, self.discr_sched,
                                       self.discr_names, self.discr_params,
                                       self.discr_max_grad_norm, self.discr_warmup_steps))
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
            "torch_generator_state": self.generator.get_state().numpy().tobytes().hex()})
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
        self._load_opt(arrays, "['gen_opt']", self.gen_opt, self.gen_sched, self.gen_names,
                       self.gen_params, self.max_grad_norm, self.warmup_steps)
        self._load_opt(arrays, "['discr_opt']", self.discr_opt, self.discr_sched,
                       self.discr_names, self.discr_params, self.discr_max_grad_norm,
                       self.discr_warmup_steps)
        if self.ema is not None:
            self.ema.shadow.load_state_dict(codec_state_dict_from_jax(under("['ema'].shadow")))
            self.ema.step = int(arrays["['ema'].step"])
        if "torch_generator_state" in meta:
            self.generator.set_state(torch.frombuffer(
                bytearray.fromhex(meta["torch_generator_state"]), dtype=torch.uint8))
        self.steps = checkpoint_num_steps(path) + 1

    def close(self):
        """Stop the data loaders' worker threads."""
        self.dl_iter.stop()
        self.valid_dl_iter.stop()
