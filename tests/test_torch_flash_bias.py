"""The port's flash attention with a materialised additive bias on the CPU:
the plain forward and the plain backward (the versions the CUDA kernels K1-K3
and K5 are held to on the card) against the JAX package's Pallas kernels
under `jax.grad`, in interpret mode, with a batch-shared (H, N, M) bias (the
fused Pallas backward, whose bias gradient is `_dbias_kernel`) and a
per-batch (B, H, N, M) bias (the JAX package's chunked XLA backward); the
autograd.Function on CPU tensors, which launches nothing; and the arguments
the wrapper refuses.

Tolerances: 2e-3 on the forward, rtol 1e-2 / atol 1e-3 on gradients (the
JAX package's flash-attention tolerances), 1e-5 against torch autograd
through the plain forward (the same float32 arithmetic in another order)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.ops.pallas.flash_attention import flash_attention as j_flash

from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa

from torch_port_util import t

TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = dict(rtol=1e-2, atol=1e-3)
# (n, causal, mqa, key mask): lengths aligned and not to the 16-row tiles
CASES = list(itertools.product([48, 50], [True, False], [True, False], [True, False]))


def _inputs(n, mqa, masked, seed=0, b=2, h=4, d=32, per_batch=False):
    rng = np.random.default_rng(seed)
    hk = 1 if mqa else h
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    bias = (0.3 * rng.normal(size=((b,) if per_batch else ()) + (h, n, n))).astype(np.float32)
    g = rng.normal(size=(b, h, n, d)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((b, n), bool)
        mask[0, (4 * n) // 5:] = False
        mask[1, 3] = False
    return q, k, v, bias, mask, g


def _port_bwd(q, k, v, bias, mask, g, causal):
    """flash_attention_bwd_ref on the plain forward's out and lse."""
    q, k, v, bias, g = t(q), t(k), t(v), t(bias), t(g)
    mask = None if mask is None else t(mask)
    out, lse = fa.flash_attention_ref(q, k, v, bias=bias, key_mask=mask, causal=causal,
                                      return_lse=True)
    return fa.flash_attention_bwd_ref(q, k, v, None, mask, out, lse, g, causal=causal,
                                      scale=q.shape[-1] ** -0.5, bias=bias)


@pytest.mark.parametrize("n,causal,mqa,masked", CASES)
def test_plain_forward_matches_pallas(n, causal, mqa, masked):
    q, k, v, bias, mask, _ = _inputs(n, mqa, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    ref = j_flash(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias), key_mask=jmask,
                  causal=causal, block_q=16, block_k=16)
    out = fa.flash_attention(t(q), t(k), t(v), bias=t(bias),
                             key_mask=None if mask is None else t(mask), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("per_batch", [False, True])
@pytest.mark.parametrize("n,causal,mqa,masked", CASES)
def test_plain_backward_matches_pallas_backward(n, causal, mqa, masked, per_batch):
    # a shared bias takes the fused Pallas backward (`_dbias_kernel`), a
    # per-batch one the chunked XLA backward
    q, k, v, bias, mask, g = _inputs(n, mqa, masked, seed=1, per_batch=per_batch)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v, bias):
        out = j_flash(q, k, v, bias=bias, key_mask=jmask, causal=causal, block_q=16,
                      block_k=16)
        return jnp.sum(out * g)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    grads = _port_bwd(q, k, v, bias, mask, g, causal)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("n,causal,mqa,masked", CASES[::3])
def test_plain_backward_matches_autograd_through_plain_forward(n, causal, mqa, masked):
    q, k, v, bias, mask, g = _inputs(n, mqa, masked, seed=2)
    leaves = [t(a).requires_grad_() for a in (q, k, v, bias)]
    out = fa.flash_attention_ref(*leaves[:3], bias=leaves[3],
                                 key_mask=None if mask is None else t(mask), causal=causal)
    ref = torch.autograd.grad(out, leaves, t(g))
    grads = _port_bwd(q, k, v, bias, mask, g, causal)
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5, msg=name)


def test_bias_gradient_is_the_batch_sum_and_zero_above_the_diagonal():
    q, k, v, bias, mask, g = _inputs(40, True, True, seed=3)
    dbias = _port_bwd(q, k, v, bias, mask, g, causal=True)[3]
    rows = [_port_bwd(q[i:i + 1], k[i:i + 1], v[i:i + 1], bias, mask[i:i + 1], g[i:i + 1],
                      causal=True)[3] for i in range(2)]
    torch.testing.assert_close(dbias, rows[0] + rows[1], rtol=1e-5, atol=1e-6)
    above = torch.ones(40, 40, dtype=torch.bool).triu(1)
    assert float(dbias[:, above].abs().max()) == 0.0
    assert float(dbias[:, ~above].abs().max()) > 0.0


def test_autograd_function_on_cpu_tensors_launches_nothing():
    q, k, v, bias, mask, g = _inputs(33, True, True, seed=4)
    leaves = [t(a).requires_grad_() for a in (q, k, v, bias)]
    counts = (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_dtab,
              fa.launches_dbias)
    out = fa.flash_attention(*leaves[:3], bias=leaves[3], key_mask=t(mask), causal=True)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, t(g))
    assert (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_dtab,
            fa.launches_dbias) == counts
    for a, r in zip(grads, _port_bwd(q, k, v, bias, mask, g, causal=True)):
        assert torch.equal(a, r)


def test_bias_arguments_the_wrapper_refuses():
    q, k, v, bias, _, _ = _inputs(16, True, False, seed=5)
    q, k, v, bias = t(q), t(k), t(v), t(bias)
    with pytest.raises(ValueError, match="not both"):
        fa.flash_attention(q, k, v, bias=bias, bias_tab=torch.zeros(31, 4), causal=True)
    with pytest.raises(ValueError, match="bias must be"):
        fa.flash_attention(q, k, v, bias=bias[:, :8], causal=True)
    with pytest.raises(ValueError, match="bias must be"):
        fa.flash_attention(q, k, v, bias=bias[:1], causal=True)


def test_transformer_with_a_per_batch_attn_bias_matches_jax():
    """The port's Transformer given a (B, H, N, N) `attn_bias` (a bias a batch
    row, in place of the rel-pos bias) against JAX's with its flash path (the
    Pallas forward in interpret mode, the chunked XLA backward): the output,
    and the gradients of the input, the bias and every weight."""
    from audiolm_pytorch_tpu.models import transformer as jtr

    from audiolm_pytorch_tpu_torch.models import transformer as ptr
    from audiolm_pytorch_tpu_torch.weights import state_dict_from_jax

    from torch_port_util import jax_named, load_into, randomize_dynamic

    rng = np.random.default_rng(21)
    kw = dict(dim=32, depth=2, heads=2, dim_head=16, num_residual_streams=2)
    jm = randomize_dynamic(jtr.Transformer(**kw, flash_attn=True, key=jax.random.PRNGKey(21)),
                           rng, scale=0.1)
    pm = load_into(ptr.Transformer(**kw, device="cpu"), jm)
    b, n = 2, 40
    x = rng.normal(size=(b, n, 32)).astype(np.float32)
    bias = (0.5 * rng.normal(size=(b, 2, n, n))).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[1, 31:] = False
    g = rng.normal(size=(b, n, 32)).astype(np.float32)

    def jloss(m, x_, bias_):
        return (m(x_, self_attn_mask=jnp.asarray(mask), attn_bias=bias_) * g).sum()

    jout = jax.jit(lambda m, x_, bias_: m(x_, self_attn_mask=jnp.asarray(mask),
                                          attn_bias=bias_))(jm, jnp.asarray(x), jnp.asarray(bias))
    jgm, jgx, jgb = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jm, jnp.asarray(x),
                                                                jnp.asarray(bias))
    xs, bs = t(x).requires_grad_(), t(bias).requires_grad_()
    out = pm(xs, self_attn_mask=t(mask), attn_bias=bs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    params = dict(pm.named_parameters())
    # the rel-pos MLP, replaced by the bias, gets no gradient (zeros in JAX)
    grads = torch.autograd.grad((out * t(g)).sum(), [xs, bs, *params.values()],
                                allow_unused=True)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(jgb), **GRAD_TOL)
    want = state_dict_from_jax(jax_named(jgm))
    for (name, p_), got in zip(params.items(), grads[2:]):
        got = torch.zeros_like(p_) if got is None else got
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), **GRAD_TOL, err_msg=name)
