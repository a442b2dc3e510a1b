"""The port's Semantic LM training path against the JAX package on the CPU:
the forgetful causal mask, EOS append + unique-consecutive, the loss and
every parameter gradient of a small model, the optimizer against optax, and
whole train steps with gradient accumulation against the same loop written
in JAX. Both sides get the same numpy masks (the port draws from a
torch.Generator, JAX from its own keys, so their bits differ).

Tolerances: 2e-3 on losses, rtol 1e-2 / atol 1e-3 on gradients (the JAX
package's gradient tolerance), 1e-6 on optimizer steps over the same
gradients. Whole train steps are held leaf by leaf, by relative norm
||port - jax|| / ||jax||: the clipped, accumulated gradient within 1e-2 and
the step's update (parameters after minus before) within 5e-2, worst leaf
(readings: 2.8e-3 and 2.0e-2 by the third step). A leaf whose reference
gradient is at rounding level, at most 1e-6 of the largest leaf's (the
rel-pos MLP's output bias, whose true gradient is zero under the softmax's
shift invariance, reads 1e-9; the next smallest leaf 7e-5), is left out:
Adam turns its noise into updates of +-lr. The train steps run at lr 1e-5
because the small model is steep: after one step at lr 1e-3 the handful of
elements whose gradients sit at Adam's eps differ by up to 1e-3 between two
correct runs, and that alone moves other leaves' next gradients by up to
14%. The relative measure does not shrink with lr: an update that is
missing, of the wrong sign or unclipped fails it at any lr."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiolm_pytorch_tpu.models import wrappers as jw
from audiolm_pytorch_tpu.models.lm import SemanticTransformer as JSemantic
from audiolm_pytorch_tpu.nn.module import combine, partition_trainable
from audiolm_pytorch_tpu.ops import sampling as js
from audiolm_pytorch_tpu.training.optimizer import get_optimizer as j_get_optimizer

from audiolm_pytorch_tpu_torch import (SemanticTransformer, SemanticTransformerWrapper,
                                       Transformer, TransformerTrainStep, get_optimizer)
from audiolm_pytorch_tpu_torch.models import wrappers as pw
from audiolm_pytorch_tpu_torch.ops import sampling as ps
from audiolm_pytorch_tpu_torch.training.optimizer import clip_by_global_norm_
from audiolm_pytorch_tpu_torch.weights import state_dict_from_jax

from torch_port_util import jax_named, load_into, randomize_dynamic, t

REPO = Path(__file__).resolve().parents[1]
GRAD_TOL = dict(rtol=1e-2, atol=1e-3)
SMALL = dict(dim=128, depth=2, heads=2, dim_head=64, num_semantic_tokens=32)


@pytest.mark.parametrize("shape,p", [((3, 50), 0.15), ((2, 7), 0.15), ((4, 20), 0.5),
                                     ((2, 1), 0.9), ((2, 30), 0.0)])
def test_forgetful_mask_count_and_first_column(shape, p):
    mask = ps.generate_mask_with_prob(shape, p, generator=torch.Generator().manual_seed(0))
    ref = np.asarray(js.generate_mask_with_prob(jax.random.PRNGKey(0), shape, p))
    n = shape[-1]
    dropped = min(int(n * p), n - 1)
    assert mask.shape == shape and mask.dtype == torch.bool
    assert mask[:, 0].all()
    np.testing.assert_array_equal((~mask).sum(-1).numpy(), np.full(shape[0], dropped))
    np.testing.assert_array_equal((~mask).sum(-1).numpy(), (~ref).sum(-1))


def test_eos_append_then_unique_consecutive_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 4, size=(4, 25))
    ids[1, 18:] = -1  # padded row
    ids[2, :] = 3     # one repeated token
    ref = js.batch_unique_consecutive(js.append_eos_id(jnp.asarray(ids), 9), pad_value=-1)
    out = ps.batch_unique_consecutive(ps.append_eos_id(torch.from_numpy(ids), 9), pad_value=-1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _small_pair(streams, seed=0):
    jm = JSemantic(**SMALL, num_residual_streams=streams, key=jax.random.PRNGKey(seed))
    if streams > 1:
        jm = randomize_dynamic(jm, np.random.default_rng(seed))
    return jm, load_into(SemanticTransformer(**SMALL, num_residual_streams=streams,
                                             device="cpu"), jm)


def _inject_masks(monkeypatch, masks):
    """The port's forgetful masks come, in order, from the numpy `masks`;
    JAX's come from the `mask` argument of `_jax_loss_and_grads`."""
    queue = list(masks)

    def port_mask(shape, mask_prob, *, generator=None, device=None):
        m = queue.pop(0)
        assert tuple(shape) == m.shape
        return torch.from_numpy(m).to(device)

    def jax_mask(key, shape, mask_prob):
        assert tuple(shape) == _JAX_MASK[0].shape
        return _JAX_MASK[0]

    monkeypatch.setattr(pw, "generate_mask_with_prob", port_mask)
    monkeypatch.setattr(jw, "generate_mask_with_prob", jax_mask)


def _masks(rng, count, b, n, p=0.15):
    out = []
    for _ in range(count):
        m = np.ones((b, n), bool)
        for row in m:
            row[1 + rng.permutation(n - 1)[:int(n * p)]] = False
        out.append(m)
    return out


_JAX_MASK = [None]  # the mask the patched JAX draw returns while `_loss` is traced


def _loss(params, rest, ids, mask):
    _JAX_MASK[0] = mask
    return jw.SemanticTransformerWrapper(transformer=combine(params, rest))(
        semantic_token_ids=ids, return_loss=True, train=True, key=jax.random.PRNGKey(0))


_jax_value_and_grad = jax.jit(jax.value_and_grad(_loss))


def _jax_loss_and_grads(jm, ids, mask):
    params, rest = partition_trainable(jm)
    return _jax_value_and_grad(params, rest, jnp.asarray(ids), jnp.asarray(mask))


@pytest.mark.parametrize("streams", [4, 1])
def test_loss_and_every_gradient_match_jax(streams, monkeypatch):
    jm, pm = _small_pair(streams)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 32, size=(2, 40))
    ids[1, 30:] = -1
    mask, = _masks(rng, 1, 2, 40)
    _inject_masks(monkeypatch, [mask])
    loss_ref, grads_ref = _jax_loss_and_grads(jm, ids, mask)
    loss = SemanticTransformerWrapper(transformer=pm)(torch.from_numpy(ids), return_loss=True,
                                                      train=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=2e-3, atol=2e-3)
    ref = state_dict_from_jax(jax_named(grads_ref))
    named = dict(pm.named_parameters())
    assert set(ref) == set(named)
    for name, g in ref.items():
        p = named[name]
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), g.numpy(), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("cosine", [False, True])
def test_optimizer_matches_optax(cosine):
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 5), "b": (5,), "e": (3, 2, 4), "s": ()}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(warmup_steps=2, total_steps=5, cosine_decay=cosine)
    tx = j_get_optimizer(1e-2, 0.1, max_grad_norm=0.5, **kw)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.nn.Parameter(t(v)) for k, v in init.items()}
    opt, sched = get_optimizer(list(params.values()), 1e-2, 0.1, **kw)
    for step in range(3):
        # global norms above and below the clip
        scale = 1.0 if step != 1 else 0.01
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = t(grads[k])
        clip_by_global_norm_([p.grad for p in params.values()], 0.5)
        opt.step()
        sched.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"step {step} {k}")
    # with warmup the first update has learning rate 0: params moved only by steps 2-3
    assert not np.allclose(params["w"].detach().numpy(), init["w"])


def _above_rounding(grads):
    """The leaves whose gradient norm is over 1e-6 of the largest leaf's."""
    top = max(float(g.norm()) for g in grads.values())
    return {name for name, g in grads.items() if float(g.norm()) > 1e-6 * top}


def _leaf_errors(got, ref, leaves):
    """{leaf: ||got - ref|| / ||ref||} over `leaves`."""
    return {name: float((got[name] - ref[name]).norm() / ref[name].norm()) for name in leaves}


def _assert_leaves_within(errors, limit, what):
    worst = max(errors, key=errors.get)
    assert errors[worst] <= limit, f"{what}: {worst} off by {errors[worst]:.3e} > {limit}"


# (max_grad_norm): the clip active (every step's norm is over 0.5), and off,
# where the 1 / grad_accum_every scale shows in the gradient itself
@pytest.mark.parametrize("max_grad_norm", [0.5, None])
def test_train_steps_with_accumulation_match_jax_loop(monkeypatch, max_grad_norm):
    jm, pm = _small_pair(4, seed=3)
    rng = np.random.default_rng(4)
    steps, accum, b, n = 3, 2, 2, 36
    batches = [rng.integers(0, 32, size=(accum * b, n)) for _ in range(steps)]
    masks = _masks(rng, steps * accum, b, n)
    _inject_masks(monkeypatch, masks)

    lr = 1e-5
    trainer = TransformerTrainStep(SemanticTransformerWrapper(transformer=pm), lr=lr,
                                   grad_accum_every=accum, max_grad_norm=max_grad_norm,
                                   device="cpu")
    # the JAX trainer's step (`_build_step`) as a plain loop over the same masks
    tx = j_get_optimizer(lr, 0.0, max_grad_norm=max_grad_norm)
    params, rest = partition_trainable(jm)
    state = tx.init(params)
    for step, ids in enumerate(batches):
        before = {name: p.detach().clone() for name, p in pm.named_parameters()}
        loss = trainer.step(torch.from_numpy(ids))
        gacc, lsum = None, 0.0
        for micro in ids.reshape(accum, b, n):
            ref_loss, grads = _jax_loss_and_grads(combine(params, rest), micro, masks.pop(0))
            grads = jax.tree_util.tree_map(lambda g: g / accum, grads)
            gacc = grads if gacc is None else jax.tree_util.tree_map(jnp.add, gacc, grads)
            lsum += float(ref_loss)
        clipped = gacc
        if max_grad_norm is not None:
            assert float(optax.global_norm(gacc)) > max_grad_norm  # the clip acts
            clipped, _ = optax.clip_by_global_norm(max_grad_norm).update(gacc,
                                                                         optax.EmptyState())
        updates, state = tx.update(gacc, state, params)
        params = optax.apply_updates(params, updates)

        np.testing.assert_allclose(loss, lsum / accum, rtol=2e-3, atol=2e-3)
        named = dict(pm.named_parameters())
        ref_grads = state_dict_from_jax(jax_named(clipped))
        leaves = _above_rounding(ref_grads)
        # the trainer leaves the clipped, accumulated gradient in .grad
        _assert_leaves_within(
            _leaf_errors({k: p.grad for k, p in named.items()}, ref_grads, leaves),
            1e-2, f"step {step} gradient")
        _assert_leaves_within(
            _leaf_errors({k: p.detach() - before[k] for k, p in named.items()},
                         state_dict_from_jax(jax_named(updates)), leaves),
            5e-2, f"step {step} update")


def test_dropout_is_refused_not_ignored():
    for kw in (dict(attn_dropout=0.1), dict(ff_dropout=0.1)):
        with pytest.raises(NotImplementedError):
            SemanticTransformer(**SMALL, device="cpu", **kw)
        with pytest.raises(NotImplementedError):
            Transformer(dim=64, depth=1, heads=2, device="cpu", **kw)


def test_port_imports_without_jax():
    # the card's machine has no JAX: the port and its training modules must not need it
    code = ("import sys; sys.modules['jax'] = None; sys.modules['audiolm_pytorch_tpu'] = None; "
            "import audiolm_pytorch_tpu_torch, audiolm_pytorch_tpu_torch.training.trainer, "
            "audiolm_pytorch_tpu_torch.training.optimizer; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, check=False)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
