"""One rank of the port's tensor-parallel checks on a (data, model) mesh (or,
with --world 1, one process on the whole batch): train steps of a Semantic,
a Coarse and a Fine LM (the forgetful mask, the global-norm clip; the
Semantic one with dropout, and again in bf16 compute), each LM's eval
loss, the full state_dict gathered back after the sharding, a Semantic LM
whose feed-forward stays replicated under the pair rule, KV-cached generation of the three (greedy,
and the Semantic one sampled from a seed), and, on the ranks, the Semantic
step again with the `copy_in` of the attention's shared k and v skipped.
Writes what each gave to <out>/rank<r>.pt (or single.pt).

    python tests/torch_tp_worker.py --rank R --world W --port P --out DIR [--model M]

Imports torch, numpy and the port only; the ranks join a gloo group on the
CPU, W / M data ranks of M model ranks each (M = 2 by default)."""
import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from audiolm_pytorch_tpu_torch import (CoarseTransformer, CoarseTransformerWrapper,  # noqa: E402
                                       FineTransformer, FineTransformerWrapper,
                                       SemanticTransformer, SemanticTransformerWrapper,
                                       TransformerTrainStep)
from audiolm_pytorch_tpu_torch.models import transformer as transformer_mod  # noqa: E402
from audiolm_pytorch_tpu_torch.parallel import mesh as dp  # noqa: E402
from audiolm_pytorch_tpu_torch.parallel import tp  # noqa: E402

# 4 heads of 16 and inner 128: the pair rule cuts attention and feed-forward
# at 2 model ranks; vocab 21 (odd): the embedding and logits over the features
SEMANTIC = dict(dim=48, depth=2, heads=4, dim_head=16, num_semantic_tokens=20,
                num_residual_streams=4, attn_dropout=0.1, ff_dropout=0.1)
# inner int(32 * 8 / 3) = 85: the feed-forward stays replicated; vocab 24 (even):
# the embedding and logits over the vocabulary
FF_WHOLE = dict(dim=32, depth=2, heads=4, dim_head=16, num_semantic_tokens=23,
                num_residual_streams=2)
# the coarse table (2 x 17 = 34 rows) over the vocabulary, the semantic table
# (21 rows) and the heads (17 classes) over the features
COARSE = dict(codebook_size=16, num_coarse_quantizers=2, dim=48, depth=2, heads=4, dim_head=16,
              num_semantic_tokens=20, num_residual_streams=2)
# both tables (32 rows each) and both heads (16 classes) over the vocabulary
FINE = dict(num_coarse_quantizers=2, num_fine_quantizers=2, codebook_size=16, dim=48, depth=2,
            heads=4, dim_head=16, num_residual_streams=2)
KINDS = {"semantic": (SemanticTransformer, SEMANTIC, SemanticTransformerWrapper),
         "ff_whole": (SemanticTransformer, FF_WHOLE, SemanticTransformerWrapper),
         "coarse": (CoarseTransformer, COARSE, CoarseTransformerWrapper),
         "fine": (FineTransformer, FINE, FineTransformerWrapper)}
BATCH = 4
# the hyper-connections' dynamic weights are drawn at this scale: at 0.5 (the
# JAX parity tests' `randomize_dynamic`) these tiny LMs' float32 gradients
# move by up to 3.6e-4 when every weight moves by 1e-7 of itself, so no
# comparison could hold them to 1e-5; at 0.1 by about 2e-6 (`sensitivity`)
DYN_SCALE = 0.1


def build(kind, dropout=True, jitter=0.0):
    """The LM of `kind` from seed 3, its hyper-connections' dynamic weights
    (zero at init) drawn from numpy; without `dropout`, its dropout off;
    with `jitter`, every weight then scaled by 1 + jitter * N(0, 1)."""
    cls, cfg, _ = KINDS[kind]
    if not dropout:
        cfg = dict(cfg, attn_dropout=0.0, ff_dropout=0.0)
    lm = cls(**cfg, seed=3, device="cpu")
    rng, noise = np.random.default_rng(4), np.random.default_rng(9)
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if "dyn_alpha_w" in name or "dyn_beta_w" in name:
                p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)
                                         * DYN_SCALE))
            elif "dyn_alpha_scale" in name or "dyn_beta_scale" in name:
                p.fill_(float(rng.uniform(0.2, 0.5)))
            if jitter:
                p.mul_(1 + jitter * torch.from_numpy(
                    noise.normal(size=tuple(p.shape)).astype(np.float32)))
    return lm


def distinct(rng, b, n, vocab):
    """Ids with no consecutive repeats (unique_consecutive keeps each, so each
    data rank's loss is a mean over the same count)."""
    return np.cumsum(rng.integers(1, vocab, size=(b, n)), axis=1) % vocab


def batch(kind):
    """The step's inputs of `kind`, as numpy arrays."""
    rng = np.random.default_rng(5)
    if kind in ("semantic", "ff_whole"):
        return (distinct(rng, BATCH, 24, KINDS[kind][1]["num_semantic_tokens"]),)
    if kind == "coarse":
        return distinct(rng, BATCH, 7, 20), rng.integers(0, 16, size=(BATCH, 5 * 2))
    return rng.integers(0, 16, size=(BATCH, 5 * 2)), rng.integers(0, 16, size=(BATCH, 4 * 2))


@contextlib.contextmanager
def kv_copy_in_skipped():
    """The planted fault: within the block the attention's `copy_in` passes
    the shared k and v (last dim dim_head) as they are, so `to_kv`, the null
    key and the first layer's values get only the gradient of the rank's own
    heads; the queries' `copy_in` stays."""
    real = transformer_mod.copy_in
    transformer_mod.copy_in = lambda x, group: x if x.shape[-1] == 16 else real(x, group)
    try:
        yield
    finally:
        transformer_mod.copy_in = real


def train(kind, mesh, dropout=True, jitter=0.0, bf16=False):
    """One step of `kind` on the whole batch (cut over the data ranks), in
    bf16 compute with `bf16`: its eval loss first, the step's loss, the full
    gradients after the clip, the full parameters after the update, and this
    rank's own gradients of the replicated parameters."""
    lm = build(kind, dropout, jitter)
    wrapper = KINDS[kind][2](transformer=lm)
    step = TransformerTrainStep(wrapper, lr=1e-3, seed=6, mesh=mesh, bf16_compute=bf16,
                                device="cpu")
    out = {"state": tp.tp_full_state_dict(lm)}
    inputs = [torch.from_numpy(a) for a in batch(kind)]
    with torch.no_grad():
        out["eval_loss"] = wrapper(*inputs, return_loss=True).item()
    out["loss"] = step.step(*inputs)
    out["grads"] = tp.tp_full_state_dict(lm, grads=True)
    out["params"] = tp.tp_full_state_dict(lm)
    out["replicated_grads"] = {n: p.grad.clone() for n, p in lm.named_parameters()
                               if n not in lm.tp_dims}
    out["cut"] = dict(lm.tp_dims)
    return out, wrapper


def generate(kind, wrapper, mesh):
    """KV-cached generation: greedy for each LM, and the Semantic LM sampled
    from a seeded generator at temperature 1 (its batch split over the data
    ranks)."""
    rng = np.random.default_rng(7)
    greedy = dict(temperature=1e-10)
    if kind == "semantic":
        prime = torch.from_numpy(distinct(rng, BATCH, 5, 20))
        return {"greedy": wrapper.generate(max_length=12, prime_ids=prime, mesh=mesh, **greedy),
                "sampled": wrapper.generate(max_length=12, prime_ids=prime, mesh=mesh,
                                            generator=torch.Generator().manual_seed(8))}
    if kind == "coarse":
        sem = torch.from_numpy(rng.integers(0, 20, size=(2, 6)))
        return {"greedy": wrapper.generate(semantic_token_ids=sem, max_time_steps=4, **greedy)}
    coarse = torch.from_numpy(rng.integers(0, 16, size=(2, 4, 2)))
    prime = torch.from_numpy(rng.integers(0, 16, size=(2, 2)))
    return {"greedy": wrapper.generate(coarse_token_ids=coarse, prime_fine_token_ids=prime,
                                       **greedy)}


def run(mesh):
    out = {}
    for kind in ("semantic", "coarse", "fine"):
        out[kind], wrapper = train(kind, mesh)
        out[kind].update(generate(kind, wrapper, mesh))
    out["ff_whole"], _ = train("ff_whole", mesh)
    out["semantic_bf16"], _ = train("semantic", mesh, dropout=False, bf16=True)
    if mesh is not None:
        with kv_copy_in_skipped():
            out["fault"], _ = train("semantic", mesh)
    else:
        # the float32 rounding sensitivity of the one process's step: its
        # weights moved by 1e-7 of themselves
        for kind in ("semantic", "coarse", "fine", "ff_whole"):
            out[f"{kind}_jittered"] = train(kind, None, jitter=1e-7)[0]["grads"]
    out["all_reduces"] = tp.all_reduces
    return out


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--model", type=int, default=2)
    parser.add_argument("--port", type=int, default=29500)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    torch.set_num_threads(1)
    mesh = None
    if args.world > 1:
        dp.init_process_group(args.rank, args.world, init_method=f"tcp://localhost:{args.port}",
                              device="cpu")
        mesh = dp.make_mesh(num_model=args.model)
    name = f"rank{args.rank}" if mesh is not None else "single"
    try:
        out = run(mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    torch.save(out, Path(args.out) / f"{name}.pt")


if __name__ == "__main__":
    main()
