"""Tensor parallelism of the three LMs over a mesh's model dimension, held
against the JAX package's `parallel/tp.py` (`tp_rules_for_lm`,
`shard_by_rules`, `apply_tp_sharding`).

The JAX package annotates each leaf's sharding and lets GSPMD insert the
collectives. Here they are explicit, in Megatron's layout over the model
group of `parallel.mesh.make_mesh(num_data, num_model)`:

- attention: `to_q` column-parallel (the rank's `heads / m` heads),
  `to_out` row-parallel; k and v come from the replicated `to_kv` (MQA's
  one head, so every rank holds the KV cache whole), and K1-K5 run on the
  rank's heads with its cut of the rel-pos table or of the `(H, N, M)` bias;
- the feed-forward: `proj_in` column-parallel, its rows permuted so that a
  rank holds matching parts of GEGLU's x and gate; the LayerNorm over the
  inner width from all-reduced statistics, its gamma cut; `proj_out`
  row-parallel;
- embeddings and logit heads cut over the vocabulary where it divides, else
  over the features;
- everything else replicated.

The collectives are `torch.autograd.Function`s over `dist.all_reduce` alone,
so they run on every backend (gloo on CUDA tensors too, which lets two
ranks share one card, where NCCL refuses): `copy_in` (identity forward,
the gradient summed over the group: Megatron's f), `reduce_out` (the
partial results summed, the gradient passed as it is: g), `sum_over` (a sum
that each rank then uses on its own part: summed both ways), `cut` (the
rank's part of a replicated tensor; the gradient zero-padded and summed)
and `gather` (the parts of every rank in order, as `parallel.mesh.
gather_rows` does it: a zeroed buffer all-reduced; the gradient the rank's
part). Each is the identity without a group. Low-precision tensors are
summed in float32. The kernels' `autograd.Function`s see plain local
tensors. After a backward every replicated parameter holds the same full
gradient on every model rank and every cut one the gradient of its part;
the activations between the layers are the same on every rank.

The rules: JAX's seven patterns, matched against each parameter's JAX key
path (`weights.lm_jax_path`), the first of a rule's dims that divides
(and holds at least two rows a rank) wins, translated to the port's
layout (a Linear weight is `(out, in)` here, `(in, out)` in JAX). Then the
pair rule: `to_q` and `to_out` are cut only when the heads divide, and
`proj_in` and `proj_out` only when the inner width does (a head is never
split), else both stay replicated; the feed-forward's inner LayerNorm
gamma follows its pair. GSPMD computes the same numbers from JAX's table
either way.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..weights import lm_jax_path
from .mesh import model_coords

__all__ = ["ModelGroup", "tp_rules_for_lm", "apply_tp_sharding", "tp_full_state_dict",
           "copy_in", "reduce_out", "sum_over", "cut", "gather", "embedding", "project",
           "layer_norm", "all_reduces", "all_reduce_bytes"]

# collectives and the bytes they sum, counted where they run
all_reduces = 0
all_reduce_bytes = 0


@dataclass(frozen=True)
class ModelGroup:
    """A rank's model group: the process group, the rank in it, its size."""
    group: "dist.ProcessGroup"
    rank: int
    world: int


def _all_reduce(t, tp):
    """A copy of t summed over the model group (in float32 for lower
    precision, then cast back)."""
    global all_reduces, all_reduce_bytes
    wide = t.dtype if t.dtype in (torch.float32, torch.float64) else torch.float32
    buf = t.to(wide, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=tp.group)
    all_reduces += 1
    all_reduce_bytes += buf.numel() * buf.element_size()
    return buf.to(t.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        n = x.shape[dim] // tp.world
        ctx.tp, ctx.dim, ctx.n, ctx.shape = tp, dim, n, x.shape
        return x.narrow(dim, tp.rank * n, n).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        tp, n = ctx.tp, ctx.n
        full = g.new_zeros(ctx.shape)
        full.narrow(ctx.dim, tp.rank * n, n).copy_(g)
        return _all_reduce(full, tp), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        n = x.shape[dim]
        ctx.tp, ctx.dim, ctx.n = tp, dim, n
        shape = list(x.shape)
        shape[dim] = n * tp.world
        buf = x.new_zeros(shape)
        buf.narrow(dim, tp.rank * n, n).copy_(x)
        return _all_reduce(buf, tp)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n).contiguous(), None, None


def _on(tp):
    return tp is not None and tp.world > 1


def copy_in(x, tp):
    """x, whose gradient is summed over the model group (the input of a
    column-parallel product, or of any computation on the rank's part)."""
    return _CopyIn.apply(x, tp) if _on(tp) else x


def reduce_out(x, tp):
    """The ranks' partial results x summed (the output of a row-parallel
    product); the gradient passes as it is."""
    return _ReduceOut.apply(x, tp) if _on(tp) else x


def sum_over(x, tp):
    """x summed over the model group, each rank then using the sum on its
    own part (a LayerNorm's statistics): the gradient is summed too."""
    return _SumOver.apply(x, tp) if _on(tp) else x


def cut(x, dim, tp):
    """The rank's contiguous part of the replicated x along dim; its gradient
    zero-padded to x's shape and summed over the group, so whatever
    computed x gets the gradient of every rank's part."""
    return _Cut.apply(x, dim % x.ndim, tp) if _on(tp) else x


def gather(x, dim, tp):
    """Every rank's x along dim, in rank order (exact: each element is one
    rank's value plus zeros); the gradient the rank's part."""
    return _Gather.apply(x, dim % x.ndim, tp) if _on(tp) else x


def embedding(table, idx, dim, tp):
    """The full rows of a table for the indices idx, on every rank, from the
    rank's part of it: `dim` None (replicated) table[idx]; 0 (cut over the
    rows) the rank's rows, zeros for the indices outside its range, summed
    over the group; 1 (cut over the features) the rank's columns gathered."""
    if not _on(tp) or dim is None:
        return table[idx]
    idx = torch.as_tensor(idx, device=table.device)
    if dim == 0:
        n = table.shape[0]
        local = idx - tp.rank * n
        inside = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        return reduce_out(torch.where(inside[..., None], rows, 0.0), tp)
    return gather(table[idx], -1, tp)


def project(x, product, shard_in, tp):
    """product(x), whose weight is the rank's part, as the full result on
    every rank: `shard_in` None (replicated) product(x); False (the weight
    cut over its outputs) the ranks' outputs gathered along the last dim;
    True (cut over its inputs, x's last dim) the partial products summed."""
    if not _on(tp) or shard_in is None:
        return product(x)
    if shard_in:
        return reduce_out(product(cut(x, -1, tp)), tp)
    return gather(product(copy_in(x, tp)), -1, tp)


def layer_norm(x, gamma, tp, eps: float = 1e-5):
    """The gamma-only LayerNorm of `nn.layers` over a last dim cut over the
    model group (gamma the rank's part): the mean from the summed row sums,
    the variance from the summed squared deviations from it (two passes),
    in float32, as F.layer_norm computes it in one process."""
    x32 = x.float()
    count = x.shape[-1] * tp.world
    mean = sum_over(x32.sum(-1, keepdim=True), tp) / count
    dev = x32 - mean
    var = sum_over(dev.square().sum(-1, keepdim=True), tp) / count
    return (dev * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


# The JAX package's `_LM_TP_RULES`: pattern over the JAX key path -> the dims
# to try in order, in JAX's layout (first divisible wins; first pattern owns)
_LM_TP_RULES = (
    (re.compile(r"\.to_q\.weight$"), (1,)),
    (re.compile(r"\.to_out\.weight$"), (0,)),
    (re.compile(r"\.proj_in\.weight$"), (1,)),
    (re.compile(r"\.proj_out\.weight$"), (0,)),
    (re.compile(r"embedding\]?$|embedding\.weight$"), (0, 1)),
    (re.compile(r"\.to_logits\.weight$"), (1, 0)),
    (re.compile(r"logit_weights\]?$"), (1, 2)),
)
# (the cut of the pair, its partner, what must divide: "heads" or "inner")
_PAIRS = (("to_q.weight", "to_out.weight", "heads"),
          ("proj_in.weight", "proj_out.weight", "inner"))


def _lm_of(model):
    """(the LM, its key prefix) of an LM or of a wrapper holding one."""
    inner = getattr(model, "transformer", None)
    if inner is not None and hasattr(inner, "transformer"):
        return inner, "transformer."
    return model, ""


def _jax_rule_dim(key, shape, num_model):
    """The port's dim that JAX's rules cut for the parameter `key` of this
    shape, or None."""
    transposed = key.rsplit(".", 1)[-1] == "weight" and len(shape) == 2
    jshape = tuple(reversed(shape)) if transposed else tuple(shape)
    path = lm_jax_path(key)
    for pattern, dims in _LM_TP_RULES:
        if not pattern.search(path):
            continue
        for dim in dims:
            if len(jshape) > dim and jshape[dim] % num_model == 0 \
                    and jshape[dim] >= 2 * num_model:
                return 1 - dim if transposed else dim
        return None
    return None


def tp_rules_for_lm(model, num_model: int):
    """{state_dict key: the dim cut over the model group, or None} of every
    parameter of an LM (or of a wrapper's LM, its keys prefixed
    `transformer.`): JAX's rules, then the pair rule and the feed-forward's
    inner gamma (see the module's docstring)."""
    lm, prefix = _lm_of(model)
    params = dict(lm.named_parameters())
    rules = {k: _jax_rule_dim(k, p.shape, num_model) for k, p in params.items()}
    heads = lm.transformer.heads
    for key in list(rules):
        for first, second, by in _PAIRS:
            if not key.endswith("." + first):
                continue
            base = key[: -len(first)]
            partner = base + second
            width = heads if by == "heads" else params[partner].shape[1]
            keep = width % num_model == 0 and rules[key] is not None \
                and rules[partner] is not None
            if not keep:
                rules[key] = rules[partner] = None
            if by == "inner":
                rules[base + "norm.gamma"] = 0 if keep else None
    return {prefix + k: d for k, d in rules.items()}


def _geglu_order(rows: int, world: int):
    """The row order of `proj_in`'s (2 * inner, D) weight that puts rank r's
    part of GEGLU's x and of its gate in its contiguous r-th slice."""
    inner, n = rows // 2, rows // 2 // world
    return torch.cat([torch.cat([torch.arange(r * n, (r + 1) * n),
                                 inner + torch.arange(r * n, (r + 1) * n)])
                      for r in range(world)])


def apply_tp_sharding(model, mesh):
    """Turn an LM, or a wrapper's LM, into this rank's part of it over
    `mesh`'s model dimension, in place: each parameter that
    `tp_rules_for_lm` cuts becomes the rank's slice (`proj_in` in the order
    of `_geglu_order`), and the sharded attention and feed-forward modules,
    the transformer (which then cuts its rel-pos table) and the LM learn
    their group. A model already sharded over the same group is left as
    it is; a mesh without a model dimension changes nothing. Build the
    optimizer after this. Returns the rules."""
    from ..models.transformer import Attention
    from ..nn.layers import FeedForward
    group, rank, world = model_coords(mesh)
    if world == 1:
        return {}
    lm, prefix = _lm_of(model)
    rules = tp_rules_for_lm(lm, world)
    if lm.tp is not None:
        if lm.tp.group is not group:
            raise ValueError("the model is already sharded over another group")
        return {prefix + k: d for k, d in rules.items()}
    tp = ModelGroup(group, rank, world)
    params = dict(lm.named_parameters())
    with torch.no_grad():
        for key, dim in rules.items():
            if dim is None:
                continue
            full = params[key].data
            if key.endswith("proj_in.weight"):
                full = full[_geglu_order(full.shape[0], world).to(full.device)]
            n = full.shape[dim] // world
            params[key].data = full.narrow(dim, rank * n, n).contiguous()
    for name, module in lm.named_modules():
        if isinstance(module, Attention) and rules.get(f"{name}.to_q.weight") is not None:
            module.tp = tp
            lm.transformer.tp = tp
        elif isinstance(module, FeedForward) and rules.get(f"{name}.proj_in.weight") is not None:
            module.tp = tp
    lm.tp = tp
    lm.tp_dims = {k: d for k, d in rules.items() if d is not None}
    return {prefix + k: d for k, d in rules.items()}


def tp_full_state_dict(model, *, grads: bool = False):
    """The full, unsharded state_dict of a model sharded by
    `apply_tp_sharding` (its keys as the model's own), on every rank: each
    cut parameter's parts gathered and `proj_in`'s rows put back in order;
    with `grads`, the same of the parameters' gradients (zeros where there
    is none). Detached copies; a model that is not sharded gives its
    state_dict as it is."""
    lm, prefix = _lm_of(model)
    out = {}
    for key, p in model.state_dict(keep_vars=True).items():
        t = p.grad if grads else p
        if grads and t is None:
            t = torch.zeros_like(p)
        t = t.detach().clone()
        inner_key = key[len(prefix):] if key.startswith(prefix) else None
        dim = lm.tp_dims.get(inner_key) if inner_key is not None else None
        if dim is not None:
            t = gather(t, dim, lm.tp)
            if key.endswith("proj_in.weight"):
                t = t[torch.argsort(_geglu_order(t.shape[0], lm.tp.world)).to(t.device)]
        out[key] = t
    return out
