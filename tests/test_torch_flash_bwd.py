"""The port's flash-attention backward on the CPU: the plain backward
`flash_attention_bwd_ref` (the version the CUDA kernels K2-K4 are held to on
the card) against the JAX package's Pallas backward under `jax.grad`
(interpret mode, as tests/test_flash_attention.py runs it) and against torch
autograd through the plain forward; the fully masked row; and the
autograd.Function on CPU tensors, which launches nothing.

Tolerances: rtol 1e-2 / atol 1e-3 against JAX (the JAX package's gradient
tolerance), 1e-5 against torch autograd (the same float32 arithmetic in
another order)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.ops.pallas.flash_attention import flash_attention as j_flash

from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa

from torch_port_util import t

GRAD_TOL = dict(rtol=1e-2, atol=1e-3)
# (n, causal, mqa, key mask): lengths aligned and not to the 16-row tiles
CASES = list(itertools.product([48, 50], [True, False], [True, False], [True, False]))


def _inputs(n, mqa, masked, seed=0, b=2, h=4, d=32):
    rng = np.random.default_rng(seed)
    hk = 1 if mqa else h
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, n, d)).astype(np.float32)
    tab = (0.3 * rng.normal(size=(2 * n - 1, h))).astype(np.float32)
    g = rng.normal(size=(b, h, n, d)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((b, n), bool)
        mask[1, (2 * n) // 3:] = False
    return q, k, v, tab, mask, g


def _port_bwd(q, k, v, tab, mask, g, causal):
    """flash_attention_bwd_ref on the plain forward's out and lse."""
    q, k, v, tab, g = t(q), t(k), t(v), t(tab), t(g)
    mask = None if mask is None else t(mask)
    out, lse = fa.flash_attention_ref(q, k, v, bias_tab=tab, key_mask=mask, causal=causal,
                                      return_lse=True)
    return fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, causal=causal,
                                      scale=q.shape[-1] ** -0.5)


@pytest.mark.parametrize("n,causal,mqa,masked", CASES)
def test_bwd_ref_matches_pallas_backward(n, causal, mqa, masked):
    q, k, v, tab, mask, g = _inputs(n, mqa, masked)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v, tab):
        out = j_flash(q, k, v, bias_tab=tab, key_mask=jmask, causal=causal,
                      block_q=16, block_k=16)
        return jnp.sum(out * g)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, tab)))
    grads = _port_bwd(q, k, v, tab, mask, g, causal)
    for name, a, r in zip(("dq", "dk", "dv", "dtab"), grads, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("n,causal,mqa,masked", CASES)
def test_bwd_ref_matches_autograd_through_plain_forward(n, causal, mqa, masked):
    q, k, v, tab, mask, g = _inputs(n, mqa, masked, seed=1)
    leaves = [t(a).requires_grad_() for a in (q, k, v, tab)]
    out = fa.flash_attention_ref(*leaves[:3], bias_tab=leaves[3],
                                 key_mask=None if mask is None else t(mask), causal=causal)
    ref = torch.autograd.grad(out, leaves, t(g))
    grads = _port_bwd(q, k, v, tab, mask, g, causal)
    for name, a, r in zip(("dq", "dk", "dv", "dtab"), grads, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5, msg=name)


def test_fully_masked_row_gets_no_gradient():
    # non-causal, every key of batch row 1 masked: lse ~ -1e30 there, p = 0
    q, k, v, tab, _, g = _inputs(40, True, False, seed=2)
    mask = np.ones((2, 40), bool)
    mask[1] = False
    dq, dk, dv, dtab = _port_bwd(q, k, v, tab, mask, g, causal=False)
    assert float(dq[1].abs().max()) == 0.0
    assert float(dk[1].abs().max()) == 0.0 and float(dv[1].abs().max()) == 0.0
    assert float(dq[0].abs().max()) > 0.0
    # the table's gradient is batch row 0's alone
    row0 = _port_bwd(q[:1], k[:1], v[:1], tab, mask[:1], g[:1], causal=False)
    torch.testing.assert_close(dtab, row0[3], rtol=1e-5, atol=1e-6)


def test_autograd_function_on_cpu_tensors_launches_nothing():
    q, k, v, tab, mask, g = _inputs(33, True, True, seed=3)
    leaves = [t(a).requires_grad_() for a in (q, k, v, tab)]
    counts = (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_dtab)
    out = fa.flash_attention(*leaves[:3], bias_tab=leaves[3], key_mask=t(mask), causal=True)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, t(g))
    assert (fa.launches, fa.launches_dq, fa.launches_dkv, fa.launches_dtab) == counts
    for a, r in zip(grads, _port_bwd(q, k, v, tab, mask, g, causal=True)):
        assert torch.equal(a, r)
