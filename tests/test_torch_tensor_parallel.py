"""The port's tensor parallelism on the CPU: four gloo ranks on a (2, 2)
(data, model) mesh (tests/torch_tp_worker.py, spawned here once with one
process on the whole batch) against that process and the JAX package.

- The rule table against JAX's `tp_rules_for_lm` for the Semantic, Coarse
  and Fine LMs at 2 and 4 model ranks: equal but where the pair rule keeps
  a pair whole (heads or inner width that does not divide) and for the
  feed-forward's inner LayerNorm gamma, which follows its pair here (JAX's
  GSPMD reshards around the replicated one).
- The full state_dict gathered after the sharding bit-equal to the
  unsharded model's, and to JAX's leaves through `lm_state_dict_to_jax`.
- Each LM's eval loss on its rank's part against the JAX wrapper's on the
  same weights (2e-3, the port's forward tolerance).
- A train step of each (the Semantic LM with dropout; the forgetful mask
  and the global-norm clip on; a Semantic LM whose feed-forward stays
  replicated): the loss within 1e-5 relative of one process's; the full
  gradients after the clip as one vector by relative norm, and the
  parameters after the update, within 1e-5 or 3x the one process's own
  rounding spread (its gradients' gap when every weight moves by 1e-7 of
  itself; 5.3e-6 for the Semantic step with dropout), whichever is larger,
  as the chip's tensor parallel phase gates against the card's repeat
  spread; each leaf within 1e-3 (the leaves whose gradient is over 1e-6 of
  the largest: the rel-pos MLP's last bias gets a gradient of float32
  noise, its rows' softmax gradients summing to zero).
- The Semantic step in bf16 compute: the loss within 3e-2 and the whole
  gradient within 5e-2 of one process's bf16 step (the port's bf16
  tolerances).
- The replicated parameters' gradients the same bits on both model ranks
  of a data group.
- Greedy and seeded sampled ids equal to one process's, the greedy ids
  to JAX's.
- The ranks' step with the `copy_in` of attention's shared k and v skipped
  fails the gradient gate.
"""
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.lm import CoarseTransformer as JCoarse
from audiolm_pytorch_tpu.models.lm import FineTransformer as JFine
from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
from audiolm_pytorch_tpu.parallel.tp import tp_rules_for_lm as jax_tp_rules

from audiolm_pytorch_tpu_torch import SemanticTransformer
from audiolm_pytorch_tpu_torch.parallel import mesh as dp
from audiolm_pytorch_tpu_torch.parallel import tp
from audiolm_pytorch_tpu_torch.weights import lm_jax_path, lm_state_dict_to_jax

import torch_tp_worker as worker
from torch_port_util import jax_replace

WORKER = Path(__file__).resolve().parent / "torch_tp_worker.py"
REL = 1e-5
LEAF_REL = 1e-3
BF16_TOL, GRAD_BF16_TOL = 3e-2, 5e-2
FWD_TOL = dict(rtol=2e-3, atol=2e-3)
JAX_CLS = {"semantic": JSemantic, "ff_whole": JSemantic, "coarse": JCoarse, "fine": JFine}
JAX_WRAPPER = {"semantic": jw.SemanticTransformerWrapper, "ff_whole": jw.SemanticTransformerWrapper,
               "coarse": jw.CoarseTransformerWrapper, "fine": jw.FineTransformerWrapper}
RANKS = ("rank0", "rank1", "rank2", "rank3")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    port = _free_port()
    cmds = [[sys.executable, str(WORKER), "--world", "1", "--out", str(out)]] + [
        [sys.executable, str(WORKER), "--rank", str(r), "--world", "4", "--model", "2",
         "--port", str(port), "--out", str(out)] for r in range(4)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate(timeout=100)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {name: torch.load(out / f"{name}.pt", weights_only=False)
            for name in ("single",) + RANKS}


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _flat(d, keys):
    return torch.cat([d[k].reshape(-1) for k in keys])


def _limit(single, kind):
    """max(REL, 3x the one process's rounding spread) of `kind`'s step."""
    ref = single[kind]["grads"]
    return max(REL, 3 * _rel(_flat(single[f"{kind}_jittered"], ref), _flat(ref, ref)))


def _gaps(got, want):
    """(loss gap, gradient vector gap, {leaf: gap} over the leaves above the
    noise, parameter gap over those leaves) of a step against one
    process's."""
    grads, ref = got["grads"], want["grads"]
    largest = max(g.norm().item() for g in ref.values())
    leaves = [k for k, g in ref.items() if g.norm().item() > 1e-6 * largest]
    return (abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            _rel(_flat(grads, ref), _flat(ref, ref)),
            {k: _rel(grads[k], ref[k]) for k in leaves},
            _rel(_flat(got["params"], leaves), _flat(want["params"], leaves)))


def _jax_lm(kind, pm):
    """The JAX LM of `kind` built by shape, holding the port model's weights."""
    shapes = jax.eval_shape(lambda: JAX_CLS[kind](**pm.config, key=jax.random.PRNGKey(0)))
    return jax_replace(shapes, lm_state_dict_to_jax(pm.state_dict()))


def _jax_dim(spec, key, ndim):
    """The port's dim of a JAX PartitionSpec (a Linear weight transposed)."""
    dims = [i for i, axis in enumerate(spec) if axis == "model"]
    if not dims:
        return None
    transposed = key.rsplit(".", 1)[-1] == "weight" and ndim == 2
    return 1 - dims[0] if transposed else dims[0]


@pytest.mark.parametrize("num_model", [2, 4])
@pytest.mark.parametrize("kind", ["semantic", "ff_whole", "coarse", "fine"])
def test_rules_equal_jax_but_for_the_pair_rule(kind, num_model):
    pm = worker.build(kind)
    ours = tp.tp_rules_for_lm(pm, num_model)
    theirs = jax_tp_rules(_jax_lm(kind, pm), num_model)
    params = dict(pm.named_parameters())
    assert set(ours) == set(params)
    heads, differ = pm.transformer.heads, []
    for key, dim in ours.items():
        want = _jax_dim(theirs[lm_jax_path(key)], key, params[key].ndim)
        if dim == want:
            continue
        differ.append(key)
        base, *leaf = key.rsplit(".", 2)
        leaf = ".".join(leaf)
        if leaf in ("to_q.weight", "to_out.weight"):
            assert dim is None and heads % num_model, key
        elif leaf in ("proj_in.weight", "proj_out.weight"):
            assert dim is None and params[base + ".proj_out.weight"].shape[1] % num_model, key
        else:  # the inner LayerNorm's gamma, cut with its feed-forward
            assert leaf == "norm.gamma" and base.endswith(".ff") and dim == 0 and want is None
            assert ours[base + ".proj_in.weight"] == 0, key
    if kind != "ff_whole":  # only the inner gammas differ where the pair rule cuts
        assert differ == [k for k in ours if k.endswith(".ff.norm.gamma")]


def test_the_pair_rule_never_splits_a_head():
    # 3 heads over 2 ranks; 4 heads of 16 over 8 ranks, where JAX's table cuts
    # the 64 query columns into 8 (half a head each) and the port keeps them whole
    for heads, num_model in ((3, 2), (4, 8)):
        lm = SemanticTransformer(dim=64, depth=1, heads=heads, dim_head=16,
                                 num_semantic_tokens=15, num_residual_streams=1, device="cpu")
        rules = tp.tp_rules_for_lm(lm, num_model)
        for leaf in ("attn.to_q.weight", "attn.to_out.weight"):
            assert rules[f"transformer.layers.0.{leaf}"] is None
        jrules = jax_tp_rules(_jax_lm("semantic", lm), num_model)
        assert "model" in tuple(jrules[".transformer.layers[0][1].to_q.weight"])


@pytest.mark.parametrize("kind", ["semantic", "coarse", "fine"])
def test_sharding_then_gathering_gives_the_model_back_bit_for_bit(runs, kind):
    want = worker.build(kind).state_dict()
    want_jax = lm_state_dict_to_jax(want)
    for rank in RANKS:
        got = runs[rank][kind]["state"]
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        got_jax = lm_state_dict_to_jax(got)
        assert all(np.array_equal(got_jax[k], want_jax[k]) for k in want_jax)
        assert runs[rank][kind]["cut"]  # the rank held parts, not the whole


@pytest.mark.parametrize("kind", ["semantic", "coarse", "fine"])
def test_eval_loss_on_the_ranks_equals_jax(runs, kind):
    pm = worker.build(kind)
    jm = _jax_lm(kind, pm)
    names = {"semantic": ("semantic_token_ids",), "coarse": ("semantic_token_ids",
                                                            "coarse_token_ids"),
             "fine": ("coarse_token_ids", "fine_token_ids")}[kind]
    inputs = dict(zip(names, map(jnp.asarray, worker.batch(kind))))
    ref = jax.jit(lambda m, x: JAX_WRAPPER[kind](transformer=m)(**x, return_loss=True))(jm, inputs)
    for rank in RANKS:
        np.testing.assert_allclose(runs[rank][kind]["eval_loss"], float(ref), **FWD_TOL)


@pytest.mark.parametrize("kind", ["semantic", "coarse", "fine", "ff_whole"])
def test_a_tensor_parallel_step_equals_one_process(runs, kind):
    single = runs["single"]
    limit = _limit(single, kind)
    for rank in RANKS:
        loss, grads, leaves, params = _gaps(runs[rank][kind], single[kind])
        assert loss <= REL and grads <= limit and params <= limit, (rank, loss, grads, params)
        worst = max(leaves, key=leaves.get)
        assert leaves[worst] <= LEAF_REL, (rank, worst, leaves[worst])


def test_a_bf16_tensor_parallel_step_equals_one_process_in_bf16(runs):
    # the ranks' partial products rounded to bfloat16 before their sum:
    # held to the port's bf16 tolerances (tests/test_torch_bf16.py)
    want = runs["single"]["semantic_bf16"]
    for rank in RANKS:
        loss, grads, _, _ = _gaps(runs[rank]["semantic_bf16"], want)
        assert loss <= BF16_TOL and grads <= GRAD_BF16_TOL, (rank, loss, grads)


def test_replicated_gradients_are_the_same_on_every_model_rank(runs):
    # ranks 0, 1 hold data rows 0-1, ranks 2, 3 rows 2-3: the model groups
    for kind in ("semantic", "coarse", "fine", "ff_whole"):
        for a, b in (("rank0", "rank1"), ("rank2", "rank3")):
            got, want = runs[a][kind]["replicated_grads"], runs[b][kind]["replicated_grads"]
            assert set(got) == set(want) and got
            assert all(torch.equal(got[k], want[k]) for k in want), kind
            assert runs[a][kind]["cut"] == runs[b][kind]["cut"]
    # whole feed-forward under the pair rule, the attention and vocab-cut tables cut
    cut = runs["rank0"]["ff_whole"]["cut"]
    assert not any(".ff." in k for k in cut)
    assert cut["semantic_embedding"] == 0 and cut["to_logits.weight"] == 0


@pytest.mark.parametrize("kind", ["semantic", "coarse", "fine"])
def test_generated_ids_equal_one_process(runs, kind):
    want = runs["single"][kind]
    for rank in RANKS:
        for mode in ("greedy", "sampled"):
            if mode in want:
                assert torch.equal(runs[rank][kind][mode], want[mode]), (rank, mode)


@pytest.mark.parametrize("kind", ["semantic", "coarse", "fine"])
def test_greedy_ids_equal_jax(runs, kind):
    # the worker generates after its train step: the JAX LM takes the weights after it
    pm = worker.build(kind)
    pm.load_state_dict(runs["single"][kind]["params"])
    jwrapper = JAX_WRAPPER[kind](transformer=_jax_lm(kind, pm))
    rng = np.random.default_rng(7)
    if kind == "semantic":
        prime = worker.distinct(rng, worker.BATCH, 5, 20)
        ref = jwrapper.generate(max_length=12, prime_ids=jnp.asarray(prime), temperature=1e-10)
    elif kind == "coarse":
        ref = jwrapper.generate(semantic_token_ids=jnp.asarray(rng.integers(0, 20, size=(2, 6))),
                                max_time_steps=4, temperature=1e-10)
    else:
        coarse = rng.integers(0, 16, size=(2, 4, 2))
        ref = jwrapper.generate(coarse_token_ids=jnp.asarray(coarse), temperature=1e-10,
                                prime_fine_token_ids=jnp.asarray(rng.integers(0, 16, size=(2, 2))))
    np.testing.assert_array_equal(runs["single"][kind]["greedy"].numpy(), np.asarray(ref))


def test_the_gate_fails_a_step_with_the_shared_kv_copy_in_skipped(runs):
    limit = _limit(runs["single"], "semantic")
    for rank in RANKS:
        _, grads, leaves, _ = _gaps(runs[rank]["fault"], runs["single"]["semantic"])
        assert grads > limit and max(leaves.values()) > LEAF_REL
        assert leaves["transformer.layers.0.attn.to_kv.weight"] > LEAF_REL


def test_tensor_parallel_helpers_do_nothing_without_a_group():
    x = torch.arange(6.0).reshape(3, 2)
    assert dp.model_coords(None) == (None, 0, 1)
    for fn in (tp.copy_in, tp.reduce_out, tp.sum_over):
        assert fn(x, None) is x
    assert tp.cut(x, 0, None) is x and tp.gather(x, 1, None) is x
    assert torch.equal(tp.embedding(x, torch.tensor([2, 0]), 0, None), x[[2, 0]])
    lm = worker.build("fine")
    assert tp.apply_tp_sharding(lm, None) == {} and lm.tp is None
    full = tp.tp_full_state_dict(lm)
    assert all(torch.equal(full[k], v) for k, v in lm.state_dict().items())
