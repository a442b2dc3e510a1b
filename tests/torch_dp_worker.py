"""One rank of the port's data-parallel checks (or, with --world 1, one
process on the whole batch): a Semantic LM train step (attention and
feed-forward dropout, the forgetful mask), two SoundStreamTrainer steps on a
tiny codec whose quantizers start uninitialised (kmeans over the gathered
rows, the EMA statistics summed over the ranks, dead codes revived, the
gradient penalty on the first step), LFQ's entropy loss and its
gradients, `replicate`, and a batch-sharded Semantic `generate`. Writes
what each gave to <out>/rank<r>.pt (or single.pt).

    python tests/torch_dp_worker.py --rank R --world W --port P --out DIR

Imports torch and the port only; a rank joins a gloo group on the CPU, or
NCCL with --device cuda."""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from audiolm_pytorch_tpu_torch import (LFQ, SemanticTransformer,  # noqa: E402
                                       SemanticTransformerWrapper, SoundStream,
                                       SoundStreamTrainer, TransformerTrainStep)
from audiolm_pytorch_tpu_torch.parallel import mesh as dp  # noqa: E402

SEMANTIC = dict(dim=32, depth=2, heads=2, dim_head=16, num_semantic_tokens=20,
                num_residual_streams=4, attn_dropout=0.1, ff_dropout=0.1)
# the tiny codec of tests/test_torch_codec.py
CODEC = dict(channels=8, strides=(2, 4), channel_mults=(2, 4), codebook_dim=32,
             codebook_size=64, rq_num_quantizers=4, attn_window_size=16, attn_heads=2,
             attn_dim_head=16, multi_spectral_window_powers_of_two=(6, 7),
             multi_spectral_n_ffts=128, multi_spectral_n_mels=32,
             multi_scale_discr_kwargs=dict(channels=4, layers=2, groups=(1, 2), chan_max=32),
             complex_stft_discr_kwargs=dict(channels=4, n_fft=128, hop_length=32,
                                            win_length=128, strides=((1, 2), (2, 2)),
                                            chan_mults=(1, 2)),
             rq_kwargs=dict(threshold_ema_dead_code=0.5))


def semantic_ids(b=4, n=24, seed=0):
    """Ids without repeats in a row, so unique_consecutive keeps every one and
    each rank's loss is a mean over the same count."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(1, 20, size=(b, n))
    return torch.from_numpy((np.cumsum(steps, axis=1) % 20).astype(np.int64))


class Clips:
    def __init__(self, n=8, t=1024, seed=1):
        rng = np.random.default_rng(seed)
        tt = np.arange(t) / 16000.0
        f = rng.uniform(200, 800, size=(n, 1))
        self.clips = list((0.5 * np.sin(2 * np.pi * f * tt)
                           + 0.05 * rng.normal(size=(n, t))).astype(np.float32))

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i]


def run(mesh, device, results):
    out = {}
    ids = semantic_ids()
    lm = SemanticTransformer(**SEMANTIC, seed=3, device=device)
    step = TransformerTrainStep(SemanticTransformerWrapper(transformer=lm), lr=1e-3, seed=5,
                                mesh=mesh, device=device)
    out["semantic_loss"] = [step.step(ids) for _ in range(2)]
    out["semantic_params"] = {k: v.detach().cpu() for k, v in lm.state_dict().items()}

    trainer = SoundStreamTrainer(
        SoundStream(**CODEC, device=device), dataset=Clips(), val_dataset=Clips(2, seed=2),
        num_train_steps=10, batch_size=4, grad_accum_every=2, lr=1e-4, warmup_steps=0,
        apply_grad_penalty_every=2, ema_update_after_step=0, ema_update_every=1,
        save_results_every=10 ** 9, save_model_every=2, results_folder=results,
        data_parallel=mesh is not None, device=device)
    try:
        out["codec_logs"] = [trainer.train_step() for _ in range(2)]
    finally:
        trainer.close()
    out["codec_state"] = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    out["codec_ema"] = {k: v.detach().cpu() for k, v in trainer.ema.shadow.state_dict().items()}
    out["saved"] = sorted(p.name for p in Path(results).glob("*.ckpt.npz"))

    # LFQ's entropy loss (the batch's mean bit probabilities) and its gradients
    lfq = LFQ(dim=16, codebook_size=256, entropy_loss_weight=0.1,
              generator=torch.Generator().manual_seed(4)).to(device)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 8, 16)).astype(np.float32))
    x = (x if mesh is None else dp.shard_batch(mesh, x)).to(device).requires_grad_()
    with dp.data_parallel(mesh):
        loss = lfq(x, train=True)[2]
        grads = torch.autograd.grad(loss, [x, lfq.project_in.weight])
        params = [g.clone() for g in grads[1:]]
        dp.all_reduce_mean(params + [loss.detach()])
        x_grad = dp.gather_rows(grads[0])
    # one process's gradient of its input rows is 1 / world of each rank's
    out["lfq"] = [loss.detach().cpu(), x_grad.cpu() / (1 if mesh is None else 2)] + \
        [p.cpu() for p in params]

    # replicate: every rank gets rank 0's tensor
    rank = 0 if mesh is None else torch.distributed.get_rank()
    out["replicated"] = dp.replicate(mesh, torch.full((3,), float(rank), device=device)).cpu() \
        if mesh is not None else torch.zeros(3)

    prime = semantic_ids(4, 5, seed=7)
    wrapper = SemanticTransformerWrapper(transformer=lm)
    out["generated"] = wrapper.generate(max_length=12, prime_ids=prime.to(device),
                                        generator=torch.Generator(device=device).manual_seed(9),
                                        mesh=mesh).cpu()
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--port", type=int, default=29500)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    torch.set_num_threads(1)
    out_dir = Path(args.out)
    mesh = None
    if args.world > 1:
        dp.init_process_group(args.rank, args.world, init_method=f"tcp://localhost:{args.port}",
                              device=args.device)
        mesh = dp.make_mesh()
    name = f"rank{args.rank}" if mesh is not None else "single"
    try:
        out = run(mesh, torch.device(args.device), out_dir / f"results_{name}"
                  if mesh is None else out_dir / "results_dp")
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    torch.save(out, out_dir / f"{name}.pt")


if __name__ == "__main__":
    main()
