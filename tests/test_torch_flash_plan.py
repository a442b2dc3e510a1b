"""The launch plans of the flash kernels K1 (forward), K2 (dq) and K3 (dk,
dv), as `ops/kernels/flash_attention.py` states them for the C launchers:
every attended (b*h, query tile, key tile) pair is visited exactly once (K1
in both dtypes, with one or two consumer warpgroups a block; K2 with its
key tiles in order), at the flagship, stage-trainer, prefix, cross and
decode shapes; K2 fills the card at the stage trainers', cross and
tensor-parallel shapes, and K5's cluster is the largest divisor of the
batch up to 8; and plain emulations of K3's blocks (each warpgroup's items,
the two warpgroups' sum, the cluster's rank order, the query chunks' order)
and of K2's (each query tile's key tiles in order) give JAX's gradients of
`attend`. The same for the head dims: each plan's fit at every head dim,
the column-sliced form over 128, and the one head-dim rule of K1, K2 and
K3 (the kernel its argument) that sends bf16's 129 to 256 to their Hopper
forms at 256, and float32's in K2 and K3 to their chunked forms (the plans,
fit, cluster and query-split rules, K3's pair forms' sum order, K1's rows
form's walk and table slice, and the padding's exactness).

Tolerances: rtol 1e-2 / atol 1e-3 against JAX, the JAX package's gradient
tolerance (tests/test_flash_attention.py)."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.ops.attention import attend

from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa
from audiolm_pytorch_tpu_torch.ops.relpos import toeplitz_expand

from torch_port_util import t

GRAD_TOL = dict(rtol=1e-2, atol=1e-3)
# (label, b, h, hk, n, m, causal): the shapes the main path gives K1 and K3
SHAPES = [("flagship", 4, 8, 1, 2049, 2049, True),
          ("aligned", 4, 8, 1, 2048, 2048, True),
          ("coarse", 4, 8, 8, 603, 603, True),
          ("stage coarse", 4, 4, 4, 602, 602, True),
          ("fine", 4, 8, 8, 1201, 1201, True),
          ("prefix", 4, 8, 1, 2049, 2049 + 16, True),
          ("cross", 4, 8, 1, 2049, 17, False),
          ("decode", 4, 8, 1, 1, 17, False),
          ("tensor parallel rank", 2, 4, 1, 2049, 2049, True)]


def attended_tiles(n, m, causal):
    """{(query tile, key tile)} holding at least one attended pair."""
    keep = np.ones((n, m), bool)
    if causal:
        keep = np.tril(keep, m - n)
    tiles = set()
    for qi in range(-(-n // 64)):
        rows = keep[qi * 64:(qi + 1) * 64]
        for ki in range(-(-m // 64)):
            if rows[:, ki * 64:(ki + 1) * 64].any():
                tiles.add((qi, ki))
    return tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_k1_plan_visits_each_attended_tile_once(label, b, h, hk, n, m, causal, dtype):
    plan = fa.fwd_plan(b, h, n, m, causal, dtype)
    assert plan["grid"] == (b * h, -(-n // 64))
    if plan["consumers"] == 1:
        assert all(not second for _, second in plan["tiles"].values())
    seen = collections.Counter()
    for qi, (first, second) in plan["tiles"].items():
        assert set(first).isdisjoint(second)
        seen.update((qi, ki) for ki in first + second)
    assert max(seen.values()) == 1
    # every attended tile, and above the diagonal none that a row could not use
    assert set(seen) >= attended_tiles(n, m, causal)
    assert all(ki * 64 < m for _, ki in seen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_k3_plan_visits_each_attended_pair_once(label, b, h, hk, n, m, causal, dtype):
    plan = fa.dkv_plan(b, h, hk, n, m, dtype)
    cluster, qsplit = plan["cluster"], plan["qsplit"]
    group = h // hk
    assert group % cluster == 0 and cluster <= 8
    assert plan["grid"] == (cluster, b * hk, -(-m // 64) * qsplit)
    keep = np.tril(np.ones((n, m), bool), m - n) if causal else np.ones((n, m), bool)
    for kv_head in range(hk):  # the batch rows repeat the same plan
        for ki in range(-(-m // 64)):
            # the query rows that see a key of this tile, per query head
            sees = keep[:, ki * 64:(ki + 1) * 64].any(1)
            rows = np.zeros((h, n), int)
            for rank in range(cluster):
                for z in range(qsplit):
                    first, second = fa.dkv_items(plan, h, hk, n, m, causal, kv_head, ki, rank, z)
                    for head, q0 in first + second:
                        assert 0 <= q0 < n
                        rows[head, q0:q0 + 64] += 1
            heads = list(range(kv_head * group, (kv_head + 1) * group))
            assert rows.max() == 1
            assert (rows[heads][:, sees] == 1).all()
            assert not rows[[hd for hd in range(h) if hd not in heads]].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_k2_plan_visits_each_attended_tile_once(label, b, h, hk, n, m, causal, dtype):
    plan = fa.dq_plan(b, h, hk, n, m, causal, dtype)
    assert plan["grid"] == (b, h, -(-n // 64))
    assert plan["stages"] == (2 if dtype == torch.float32 else 3)
    seen = collections.Counter()
    for qi, keys in plan["tiles"].items():
        assert keys == sorted(keys)
        seen.update((qi, ki) for ki in keys)
    assert max(seen.values()) == 1
    assert set(seen) >= attended_tiles(n, m, causal)
    assert all(ki * 64 < m for _, ki in seen)


@pytest.mark.parametrize("b,h,n,m,causal", [(4, 4, 602, 602, True), (4, 4, 1201, 1201, True),
                                            (4, 8, 2049, 17, False), (2, 4, 2049, 2049, True)],
                         ids=["Coarse trainer", "Fine trainer", "cross", "tensor parallel rank"])
def test_k2_plan_fills_the_card(b, h, n, m, causal):
    for dtype in (torch.float32, torch.bfloat16):
        grid = fa.dq_plan(b, h, 1, n, m, causal, dtype)["grid"]
        assert grid[0] * grid[1] * grid[2] >= fa.PLAN_SMS


@pytest.mark.parametrize("b,cluster", [(1, 1), (2, 2), (3, 3), (4, 4), (8, 8), (9, 3),
                                       (11, 1), (12, 6), (16, 8)])
def test_k2_plan_gives_k5_the_batchs_cluster(b, cluster):
    plan = fa.dq_plan(b, 8, 1, 130, 130, True, dbias=True)
    assert plan["cluster"] == cluster and b % cluster == 0
    # with one cluster a tile the sum is in rank order; past it, atomics
    assert plan["atomic"] == (b > cluster)
    assert fa.dq_plan(b, 8, 1, 130, 130, True)["cluster"] == 1


def emulate_dq(q, k, v, g, mask, causal, scale, plan):
    """dq summed as K2's blocks sum it, from a plain float32 forward's lse:
    per query tile over its key tiles in the plan's order, each tile's dS K
    from zero and added, scaled at the end."""
    b, h, n, _ = q.shape
    hk, m = k.shape[1], k.shape[2]
    out, lse = fa.flash_attention_ref(q, k, v, key_mask=mask, causal=causal, scale=scale,
                                      return_lse=True)
    delta = (g * out).sum(-1)
    keep = torch.ones(n, m, dtype=torch.bool)
    keep = keep.tril(m - n) if causal else keep
    dq = torch.zeros_like(q)
    for bi in range(b):
        for head in range(h):
            kv = head // (h // hk)
            for qi, keys in plan["tiles"].items():
                qs = slice(qi * 64, min(n, qi * 64 + 64))
                acc = torch.zeros(qs.stop - qs.start, q.shape[-1])
                for ki in keys:
                    ks = slice(ki * 64, min(m, ki * 64 + 64))
                    s = scale * q[bi, head, qs] @ k[bi, kv, ks].T
                    allowed = keep[qs, ks]
                    if mask is not None:
                        allowed = allowed & mask[bi, ks][None, :]
                    p = torch.exp(s.masked_fill(~allowed, -1e30) - lse[bi, head, qs, None])
                    ds = p * (g[bi, head, qs] @ v[bi, kv, ks].T - delta[bi, head, qs, None])
                    acc = acc + ds @ k[bi, kv, ks]
                dq[bi, head, qs] = scale * acc
    return dq


@pytest.mark.parametrize("causal", [False, True])
def test_k2_tile_order_sum_matches_jax(causal):
    """2 x 4 heads x 130 queries (MQA, 2 kv heads) over 130 keys, or over a
    prefix of 17 more with causal masking, one batch row's keys half
    masked."""
    b, h, hk, n, d = 2, 4, 2, 130, 64
    m = n + 17 if causal else n
    rng = np.random.default_rng(1)
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, m, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, m, d)).astype(np.float32)
    g = rng.normal(size=(b, h, n, d)).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[1, m // 2:] = False
    scale = d ** -0.5
    dq = emulate_dq(t(q), t(k), t(v), t(g), t(mask), causal, scale,
                    fa.dq_plan(b, h, hk, n, m, causal))

    def f(q_):
        kr, vr = (jnp.repeat(jnp.asarray(a), h // hk, axis=1) for a in (k, v))
        return attend(q_, kr, vr, mask=jnp.asarray(mask)[:, None, None, :], causal=causal,
                      scale=scale)

    _, vjp = jax.vjp(f, jnp.asarray(q))
    (jdq,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), **GRAD_TOL)


def test_k1_plan_gives_short_or_few_rows_the_other_block():
    # float32: two consumers wherever there is more than one key tile
    assert fa.fwd_plan(4, 8, 2049, 2049, True)["consumers"] == 2
    assert fa.fwd_plan(4, 8, 2049, 17, False)["consumers"] == 1
    # bf16: two consumers only where fewer than two blocks an SM would run
    assert fa.fwd_plan(4, 4, 602, 602, True, torch.bfloat16)["consumers"] == 2
    assert fa.fwd_plan(4, 8, 2049, 2049, True, torch.bfloat16)["consumers"] == 1


def test_k3_plan_splits_the_cross_form_over_more_blocks():
    plan = fa.dkv_plan(4, 8, 1, 2049, 17)
    assert plan["qsplit"] > 1
    blocks = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
    assert 32 < blocks <= fa.PLAN_SMS
    # a grid that fills the card already is not split
    assert fa.dkv_plan(4, 8, 1, 2049, 2049)["qsplit"] == 1
    # bf16 takes two consumers a block only under two blocks an SM
    assert fa.dkv_plan(4, 8, 1, 2049, 2049, torch.bfloat16)["consumers"] == 1
    assert fa.dkv_plan(4, 4, 1, 150, 150, torch.bfloat16)["consumers"] == 2


def emulate_dkv(q, k, v, g, mask, causal, scale, plan):
    """dk, dv summed as K3's blocks sum them, from a plain float32 forward's
    lse: per warpgroup over its items in order, then the first warpgroup's
    sum plus the second's, then the cluster's blocks in rank order, then the
    query chunks in order, dk scaled at the end."""
    b, h, n, _ = q.shape
    hk, m = k.shape[1], k.shape[2]
    out, lse = fa.flash_attention_ref(q, k, v, key_mask=mask, causal=causal, scale=scale,
                                      return_lse=True)
    delta = (g * out).sum(-1)
    keep = torch.ones(n, m, dtype=torch.bool).tril(m - n) if causal else torch.ones(n, m,
                                                                                    dtype=torch.bool)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for kv_head in range(hk):
            for ki in range(-(-m // 64)):
                ks = slice(ki * 64, min(m, ki * 64 + 64))
                chunks_k, chunks_v = [], []
                for z in range(plan["qsplit"]):
                    ranks_k, ranks_v = [], []
                    for rank in range(plan["cluster"]):
                        wg_k, wg_v = [], []
                        for items in fa.dkv_items(plan, h, hk, n, m, causal, kv_head, ki, rank, z):
                            sk = torch.zeros(ks.stop - ks.start, q.shape[-1])
                            sv = torch.zeros_like(sk)
                            for head, q0 in items:
                                qs = slice(q0, min(n, q0 + 64))
                                s = scale * q[bi, head, qs] @ k[bi, kv_head, ks].T
                                allowed = keep[qs, ks]
                                if mask is not None:
                                    allowed = allowed & mask[bi, ks][None, :]
                                s = s.masked_fill(~allowed, -1e30)
                                p = torch.exp(s - lse[bi, head, qs, None])
                                dp = g[bi, head, qs] @ v[bi, kv_head, ks].T
                                ds = p * (dp - delta[bi, head, qs, None])
                                sv = sv + p.T @ g[bi, head, qs]
                                sk = sk + ds.T @ q[bi, head, qs]
                            wg_k.append(sk)
                            wg_v.append(sv)
                        ranks_k.append(wg_k[0] + wg_k[1] if plan["consumers"] == 2 else wg_k[0])
                        ranks_v.append(wg_v[0] + wg_v[1] if plan["consumers"] == 2 else wg_v[0])
                    chunks_k.append(sum(ranks_k[1:], ranks_k[0]))
                    chunks_v.append(sum(ranks_v[1:], ranks_v[0]))
                dk[bi, kv_head, ks] = scale * sum(chunks_k[1:], chunks_k[0])
                dv[bi, kv_head, ks] = sum(chunks_v[1:], chunks_v[0])
    return dk, dv


@pytest.mark.parametrize("consumers", [1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_k3_split_and_fixed_order_sum_matches_jax(causal, consumers):
    """A small cross shape (2 x 4 heads x 130 queries over 17 keys, one kv
    head) with the plan's query split forced on, and with causal masking
    (M >= N: 130 over 130 + 17, a prefix of 17 keys)."""
    b, h, hk, n, d = 2, 4, 1, 130, 64
    m = 17 if not causal else n + 17
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, m, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, m, d)).astype(np.float32)
    g = rng.normal(size=(b, h, n, d)).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[1, m // 2:] = False
    scale = d ** -0.5

    plan = dict(fa.dkv_plan(b, h, hk, n, m), qsplit=2, consumers=consumers)
    assert plan["cluster"] == 4
    dk, dv = emulate_dkv(t(q), t(k), t(v), t(g), t(mask), causal, scale, plan)

    def f(k_, v_):
        return attend(jnp.asarray(q), k_, v_, mask=jnp.asarray(mask)[:, None, None, :],
                      causal=causal, scale=scale)

    _, vjp = jax.vjp(f, jnp.asarray(k), jnp.asarray(v))
    jdk, jdv = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), **GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **GRAD_TOL)


# an H100 SM's shared memory for its blocks (228 KB), each block 1 KB of it besides its own
SM_SMEM = 233472


@pytest.mark.parametrize("d", [32, 64, 128, 256, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_plans_fit_the_card_at_each_head_dim(label, b, h, hk, n, m, causal, dtype, d):
    """K1's, K2's (with K4's and with K5's buffers) and K3's blocks at head
    dims 32, 64 and 128, at 256 (bf16's Hopper forms of all three; float32's
    chunked K2 and K3 and column-sliced K1) and at the column-sliced forms'
    320 and 512: each within a block's shared memory, and as many blocks as
    each is built for within an SM's."""
    plans = [fa.fwd_plan(b, h, n, m, causal, dtype, d),
             fa.dq_plan(b, h, hk, n, m, causal, dtype, d=d),
             fa.dq_plan(b, h, hk, n, m, causal, dtype, dbias=True, d=d),
             fa.dkv_plan(b, h, hk, n, m, dtype, d)]
    for plan in plans:
        assert plan["smem"] <= fa.SMEM_LIMIT
        assert plan["blocks"] * (plan["smem"] + 1024) <= SM_SMEM
    # D = 32 takes D = 64's block shapes with smaller tiles
    if d == 32:
        wide = [fa.fwd_plan(b, h, n, m, causal, dtype),
                fa.dq_plan(b, h, hk, n, m, causal, dtype),
                fa.dq_plan(b, h, hk, n, m, causal, dtype, dbias=True),
                fa.dkv_plan(b, h, hk, n, m, dtype)]
        for plan, base in zip(plans, wide):
            assert {x: plan[x] for x in plan if x != "smem"} == \
                {x: base[x] for x in base if x != "smem"}
            assert plan["smem"] <= base["smem"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plans_at_head_dim_128(dtype):
    """At D = 128 every tile doubles: bf16 keeps K1's and K3's ring in one
    two-consumer block an SM and K2's three stages in one block; float32
    (an operand with its tf32 small parts is 64 KB) runs one consumer on a
    single stage, K2's V and K preceding each other in its slot (two items a
    key tile) and K3's Q, dO and Q again (three an item)."""
    f32 = dtype == torch.float32
    fwd = fa.fwd_plan(4, 8, 2049, 2049, True, dtype, 128)
    dq = fa.dq_plan(4, 8, 1, 2049, 2049, True, dtype, dbias=True, d=128)
    dkv = fa.dkv_plan(4, 8, 1, 2049, 2049, dtype, 128)
    assert (fwd["consumers"], fwd["stages"], fwd["blocks"]) == ((1, 1, 1) if f32 else (2, 3, 1))
    assert (dq["stages"], dq["items"], dq["blocks"]) == ((1, 2, 1) if f32 else (3, 1, 1))
    assert (dkv["consumers"], dkv["stages"], dkv["items"], dkv["blocks"]) == (
        (1, 1, 3, 1) if f32 else (2, 4, 1, 1))
    # the tiles each consumer takes are those of the D = 64 plans of that shape
    fwd64 = fa.fwd_plan(4, 8, 2049, 2049, True, dtype)
    assert sorted(sum(fwd["tiles"][0], [])) == sorted(sum(fwd64["tiles"][0], []))
    assert dq["tiles"] == fa.dq_plan(4, 8, 1, 2049, 2049, True, dtype, dbias=True)["tiles"]


@pytest.mark.parametrize("d", [192, 256, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_column_sliced_plans_visit_each_attended_pair_once_a_slice(label, b, h, hk, n, m,
                                                                   causal, dtype, d):
    """Over D = 256, and in float32's K1 over 128, every kernel runs D / 64
    blocks for each block of its grid, one a 64-wide slice of the output,
    with one shared memory for every D: K1's and K2's blocks of a slice
    visit each attended (query tile, key tile) once, K2's in order, and K3's
    blocks of a slice each attended (query head, query row) of their kv head
    once, in head order. Up to D = 256 K2 and K3 are not sliced (their
    Hopper forms: bf16's, float32's chunked), nor is bf16's K1 (the D = 256
    plan tests below)."""
    slices = d // 64
    fwd = fa.fwd_plan(b, h, n, m, causal, dtype, d)
    dq = fa.dq_plan(b, h, hk, n, m, causal, dtype, dbias=True, d=d)
    dkv = fa.dkv_plan(b, h, hk, n, m, dtype, d)
    if d <= 256:
        assert dq["slices"] == dkv["slices"] == 1
        if dtype == torch.bfloat16:
            assert fwd["slices"] == 1
            return
    for plan in (fwd, dq, dkv) if d > 256 else (fwd,):
        assert plan["slices"] == slices and plan["stages"] == 2
        assert plan["smem"] == fa.fwd_plan(b, h, n, m, causal, dtype, 512)["smem"] + (
            0 if plan is not dq else fa._K5_BYTES)
    assert fwd["consumers"] == 1 and fwd["rows"] == 64
    # each slice's blocks walk the same tiles: once each, over the attended ones
    for plan in (fwd, dq) if d > 256 else (fwd,):
        seen = collections.Counter()
        for qi, keys in plan["tiles"].items():
            keys = keys[0] if plan is fwd else keys
            assert keys == sorted(keys)
            seen.update((qi, ki) for ki in keys)
        assert max(seen.values()) == 1 and set(seen) >= attended_tiles(n, m, causal)
    if d <= 256:
        return
    assert dkv["consumers"] == 1 and not dkv["pair"]
    assert dq["items"] == dkv["items"] == 2 * slices + 1
    assert (dkv["cluster"], dkv["qsplit"]) == (1, 1)
    keep = np.tril(np.ones((n, m), bool), m - n) if causal else np.ones((n, m), bool)
    group = h // hk
    for kv_head in range(hk):
        for ki in range(-(-m // 64)):
            first, second = fa.dkv_items(dkv, h, hk, n, m, causal, kv_head, ki, 0, 0)
            assert not second and [x[0] for x in first] == sorted(x[0] for x in first)
            rows = np.zeros((h, n), int)
            for head, q0 in first:
                rows[head, q0:q0 + 64] += 1
            sees = keep[:, ki * 64:(ki + 1) * 64].any(1)
            heads = list(range(kv_head * group, (kv_head + 1) * group))
            assert rows.max() == 1 and (rows[heads][:, sees] == 1).all()


def emulate_column_sliced(q, k, v, g, tab, mask, causal, scale):
    """The column-sliced forms' arithmetic in float64 (D a multiple of 64):
    for each 64-wide output slice, each 64-row query tile against each key
    tile, S (and dP) summed over the depth's 64-wide chunks, each chunk from
    zero; the online softmax over the key tiles in order (K1), dS K's slice
    for dq (K2), and dS^T Q's and P^T dO's slices summed over the kv head's
    query heads, then their query tiles, in order (K3). Returns out, lse
    (slice 0's, and every slice's equal), dq, dk, dv."""
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    group, chunks = h // hk, range(0, d, 64)
    keep = torch.ones(n, m, dtype=torch.bool)
    keep = keep.tril(m - n) if causal else keep
    rel = toeplitz_expand(tab, n, m) if tab is not None else torch.zeros(h, n, m, dtype=q.dtype)

    def scores(x, y, qs, ks, head, bi, kv):
        s = sum(x[bi, head, qs, c:c + 64] @ y[bi, kv, ks, c:c + 64].T for c in chunks)
        allowed = keep[qs, ks] & mask[bi, ks][None, :]
        return (scale * s + rel[head, qs, ks]).masked_fill(~allowed, -1e30)

    out = torch.zeros_like(q)
    lse = torch.zeros(b, h, n, dtype=q.dtype)
    dq = torch.zeros_like(q)
    for bi in range(b):
        for head in range(h):
            kv = head // group
            for q0 in range(0, n, 64):
                qs = slice(q0, min(n, q0 + 64))
                kv_end = min(m, q0 + 64 + m - n) if causal else m
                for c0 in chunks:
                    cs = slice(c0, c0 + 64)
                    mx = torch.full((qs.stop - q0,), -1e30, dtype=q.dtype)
                    l = torch.zeros_like(mx)
                    o = torch.zeros(qs.stop - q0, 64, dtype=q.dtype)
                    for k0 in range(0, kv_end, 64):
                        ks = slice(k0, min(m, k0 + 64))
                        s = scores(q, k, qs, ks, head, bi, kv)
                        m_new = torch.maximum(mx, s.max(1).values)
                        alpha, p = torch.exp(mx - m_new), torch.exp(s - m_new[:, None])
                        l, mx = l * alpha + p.sum(1), m_new
                        o = o * alpha[:, None] + p @ v[bi, kv, ks, cs]
                    out[bi, head, qs, cs] = o / l[:, None]
                    row_lse = mx + torch.log(l)
                    if c0 > 0:
                        assert torch.equal(row_lse, lse[bi, head, qs])
                    lse[bi, head, qs] = row_lse
    delta = (g * out).sum(-1)
    for bi in range(b):
        for head in range(h):
            kv = head // group
            for q0 in range(0, n, 64):
                qs = slice(q0, min(n, q0 + 64))
                kv_end = min(m, q0 + 64 + m - n) if causal else m
                for c0 in chunks:
                    acc = torch.zeros(qs.stop - q0, 64, dtype=q.dtype)
                    for k0 in range(0, kv_end, 64):
                        ks = slice(k0, min(m, k0 + 64))
                        p = torch.exp(scores(q, k, qs, ks, head, bi, kv) - lse[bi, head, qs, None])
                        dp = sum(g[bi, head, qs, c:c + 64] @ v[bi, kv, ks, c:c + 64].T
                                 for c in chunks)
                        acc = acc + (p * (dp - delta[bi, head, qs, None])) @ k[bi, kv, ks, c0:c0 + 64]
                    dq[bi, head, qs, c0:c0 + 64] = scale * acc
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for kv in range(hk):
            for k0 in range(0, m, 64):
                ks = slice(k0, min(m, k0 + 64))
                q_start = max(0, k0 - (m - n)) if causal else 0
                for c0 in chunks:
                    cs = slice(c0, c0 + 64)
                    sk = torch.zeros(ks.stop - k0, 64, dtype=q.dtype)
                    sv = torch.zeros_like(sk)
                    for head in range(kv * group, (kv + 1) * group):
                        for q0 in range(q_start, n, 64):
                            qs = slice(q0, min(n, q0 + 64))
                            p = torch.exp(scores(q, k, qs, ks, head, bi, kv)
                                          - lse[bi, head, qs, None])
                            dp = sum(g[bi, head, qs, c:c + 64] @ v[bi, kv, ks, c:c + 64].T
                                     for c in chunks)
                            ds = p * (dp - delta[bi, head, qs, None])
                            sk = sk + ds.T @ q[bi, head, qs, cs]
                            sv = sv + p.T @ g[bi, head, qs, cs]
                    dk[bi, kv, ks, cs] = scale * sk
                    dv[bi, kv, ks, cs] = sv
    return out, lse, dq, dk, dv


@pytest.mark.parametrize("causal,m_extra", [(True, 0), (True, 17), (False, -53)])
@pytest.mark.parametrize("d", [192, 256])
def test_column_sliced_scheme_equals_the_unsliced_plain_version(d, causal, m_extra):
    """The column-sliced forms' scheme, emulated in float64 (2 x 4 heads over
    one kv head, 130 queries; causal over 130 keys with the rel-pos table,
    causal over a prefix of 17 more, and cross attention over 77 keys; one
    batch row's keys partly masked), equals the plain versions to 1e-12:
    slicing the output and chunking the depth change no result."""
    b, h, hk, n = 2, 4, 1, 130
    m = n + m_extra
    rng = np.random.default_rng(d + m)
    q, g = (torch.from_numpy(rng.normal(size=(b, h, n, d))) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, hk, m, d))) for _ in range(2))
    tab = torch.from_numpy(0.5 * rng.normal(size=(2 * n - 1, h))) if m == n else None
    mask = torch.ones(b, m, dtype=torch.bool)
    mask[1, (2 * m) // 3:] = False
    scale = d ** -0.5
    got = emulate_column_sliced(q, k, v, g, tab, mask, causal, scale)
    out, lse = fa.flash_attention_ref(q, k, v, bias_tab=tab, key_mask=mask, causal=causal,
                                      scale=scale, return_lse=True)
    dq, dk, dv, _ = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, causal=causal,
                                               scale=scale)
    tight = dict(rtol=1e-12, atol=1e-12)
    for name, a, r in zip(("out", "lse", "dq", "dk", "dv"), got, (out, lse, dq, dk, dv)):
        torch.testing.assert_close(a, r, **tight, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 32, 33, 100, 128, 129, 160, 192, 200, 255, 256, 257, 320, 512])
def test_backward_head_dim_rule(d, dtype):
    """The head dim of K1, K2 and K3 (`flash_head_dim`, one rule with the
    kernel as its argument): K7's (`native_head_dim`), but from 129 to 256
    every D goes to 256 where the kernel has a Hopper form there: K1, K2 and
    K3 in bf16, K2 and K3 (the chunked forms) in float32. So float32's
    backward runs 129-256 at 256 while its K1 keeps the column-sliced form
    over 128; over 256 every kernel is column-sliced (a multiple of 64, one
    slice a block). The forward's rule is the default; K7 keeps
    `native_head_dim`."""
    hopper = 128 < d <= 256
    for kernel in ("K1", "K2", "K3"):
        got = fa.flash_head_dim(d, dtype, kernel)
        if hopper and (dtype == torch.bfloat16 or kernel != "K1"):
            assert got == 256 and fa._slices(d, dtype, kernel) == 1
        else:
            assert got == fa.native_head_dim(d)
            assert fa._slices(d, dtype, kernel) == (got // 64 if d > 128 else 1)
    assert fa.flash_head_dim(d, dtype) == fa.flash_head_dim(d, dtype, "K1")
    assert fa.F32_DIM == fa.BF16_DIM == 256
    with pytest.raises(ValueError, match="kernel"):
        fa.flash_head_dim(d, dtype, "K7")
    # the forward, the backward and their plans follow the one rule, each
    # with its own kernel
    for plan, kernel in ((fa.fwd_plan(4, 4, 2049, 2049, True, dtype, d), "K1"),
                         (fa.dq_plan(4, 4, 1, 2049, 2049, True, dtype, d=d), "K2"),
                         (fa.dkv_plan(4, 4, 1, 2049, 2049, dtype, d), "K3")):
        assert plan["slices"] == fa._slices(d, dtype, kernel)
    assert fa.fwd_plan(4, 4, 2049, 2049, True, dtype, d)["rows"] == (
        128 if hopper and dtype == torch.bfloat16 else 64)


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_bf16_d256_backward_plans_visit_each_attended_tile_once(label, b, h, hk, n, m, causal,
                                                                d):
    """bf16's K2 and K3 at D = 256 (192 padded to it): K2 the native block
    with two stages, its key tiles up to the diagonal in order, each
    attended (query tile, key tile) once; K3 the pair form, whose two
    consumers both take every item of the block (one for dk, one for dv),
    each attended (query head, query row) of the kv head once over the
    cluster's ranks and the query chunks."""
    bf16 = torch.bfloat16
    for dbias in (False, True):
        dq = fa.dq_plan(b, h, hk, n, m, causal, bf16, dbias=dbias, d=d)
        assert (dq["slices"], dq["stages"], dq["items"], dq["blocks"]) == (1, 2, 1, 1)
        assert dq["grid"] == (b, h, -(-n // 64))
        seen = collections.Counter()
        for qi, keys in dq["tiles"].items():
            assert keys == sorted(keys)
            seen.update((qi, ki) for ki in keys)
        assert max(seen.values()) == 1 and set(seen) >= attended_tiles(n, m, causal)
        assert all(ki * 64 < m for _, ki in seen)
    dkv = fa.dkv_plan(b, h, hk, n, m, bf16, d)
    assert (dkv["slices"], dkv["consumers"], dkv["pair"], dkv["stages"], dkv["items"],
            dkv["blocks"]) == (1, 2, True, 2, 1, 1)
    keep = np.tril(np.ones((n, m), bool), m - n) if causal else np.ones((n, m), bool)
    group = h // hk
    for kv_head in range(hk):
        for ki in range(-(-m // 64)):
            sees = keep[:, ki * 64:(ki + 1) * 64].any(1)
            rows = np.zeros((h, n), int)
            for rank in range(dkv["cluster"]):
                for z in range(dkv["qsplit"]):
                    first, second = fa.dkv_items(dkv, h, hk, n, m, causal, kv_head, ki, rank, z)
                    assert not second
                    for head, q0 in first:
                        rows[head, q0:q0 + 64] += 1
            heads = list(range(kv_head * group, (kv_head + 1) * group))
            assert rows.max() == 1 and (rows[heads][:, sees] == 1).all()
            assert not rows[[x for x in range(h) if x not in heads]].any()


@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_bf16_d256_backward_plans_fit_the_card(label, b, h, hk, n, m, causal):
    """K2's block at bf16's D = 256: Q and dO 64 KB, two stages of K and V
    128 KB, the rest 1.8 KB, then K4's buffers (223,008 bytes) or K5's two dS
    buffers (231,200, the repo's tightest fit: 1,248 bytes under the
    232,448 a block may have); K3's pair form: K and V, two stages of Q and
    dO, P^T and dS^T handed between its consumers: 223,632. One block an
    SM each."""
    bf16 = torch.bfloat16
    with_k4 = fa.dq_plan(b, h, hk, n, m, causal, bf16, d=256)
    with_k5 = fa.dq_plan(b, h, hk, n, m, causal, bf16, dbias=True, d=256)
    dkv = fa.dkv_plan(b, h, hk, n, m, bf16, 256)
    assert (with_k4["smem"], with_k5["smem"], dkv["smem"]) == (223008, 231200, 223632)
    assert fa.SMEM_LIMIT - with_k5["smem"] == 1248
    for plan in (with_k4, with_k5, dkv):
        assert plan["blocks"] == 1 and plan["smem"] + 1024 <= SM_SMEM


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_bf16_d256_backward_keeps_the_cluster_and_query_split_rules(label, b, h, hk, n, m,
                                                                    causal, d):
    """K5's cluster (the largest divisor of the batch up to 8, atomics past
    one cluster a tile) and K3's cluster and query split are those of every
    native head dim."""
    bf16 = torch.bfloat16
    for batch in (b, 3, 9, 12):
        got = fa.dq_plan(batch, h, hk, n, m, causal, bf16, dbias=True, d=d)
        want = fa.dq_plan(batch, h, hk, n, m, causal, bf16, dbias=True)
        assert (got["cluster"], got["atomic"], got["grid"]) == (want["cluster"], want["atomic"],
                                                                want["grid"])
    got, want = fa.dkv_plan(b, h, hk, n, m, bf16, d), fa.dkv_plan(b, h, hk, n, m, bf16)
    assert (got["cluster"], got["qsplit"], got["grid"]) == (want["cluster"], want["qsplit"],
                                                            want["grid"])


@pytest.mark.parametrize("causal", [False, True])
def test_k3_pair_form_sum_order_matches_jax(causal):
    """bf16's K3 at D = 256 sums dk in one consumer and dv in the other, each
    over all of the block's items in order, then the cluster's ranks in rank
    order, then the query chunks in order: that scheme, emulated in float32
    at D = 256 with the plan's query split forced on (2 x 4 heads x 130
    queries over one kv head, 17 keys or a causal prefix of 17 more, one
    batch row's keys half masked), gives JAX's gradients of `attend`."""
    b, h, hk, n, d = 2, 4, 1, 130, 256
    m = 17 if not causal else n + 17
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, m, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, m, d)).astype(np.float32)
    g = rng.normal(size=(b, h, n, d)).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[1, m // 2:] = False
    scale = d ** -0.5
    plan = dict(fa.dkv_plan(b, h, hk, n, m, torch.bfloat16, d), qsplit=2)
    assert plan["pair"] and plan["cluster"] == 4
    dk, dv = emulate_dkv(t(q), t(k), t(v), t(g), t(mask), causal, scale, plan)

    def f(k_, v_):
        return attend(jnp.asarray(q), k_, v_, mask=jnp.asarray(mask)[:, None, None, :],
                      causal=causal, scale=scale)

    _, vjp = jax.vjp(f, jnp.asarray(k), jnp.asarray(v))
    jdk, jdv = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), **GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **GRAD_TOL)


@pytest.mark.parametrize("d", [129, 192, 255])
def test_bf16_backward_padding_to_256_is_exact(d):
    """What the CUDA wrapper does with a bf16 head dim from 129 to 255 in the
    backward, through the plain backward in float64: q, k, v, out and dO
    zero-padded to 256 (`flash_head_dim`), the true D's scale, the gradients
    sliced back, equal the unpadded plain backward's to 1e-12, and their
    padded columns are zeros."""
    b, h, hk, n = 2, 2, 1, 70
    rng = np.random.default_rng(d)
    q, g = (torch.from_numpy(rng.normal(size=(b, h, n, d))) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, hk, n, d))) for _ in range(2))
    tab = torch.from_numpy(0.5 * rng.normal(size=(2 * n - 1, h)))
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[1, 50:] = False
    kw = dict(causal=True, scale=d ** -0.5)
    out, lse = fa.flash_attention_ref(q, k, v, bias_tab=tab, key_mask=mask, return_lse=True, **kw)
    want = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, **kw)
    dn = fa.flash_head_dim(d, torch.bfloat16)
    padded = fa._padded(q, k, v, g, out, d=dn)
    assert dn == 256 and all(x.shape[-1] == 256 for x in padded)
    qp, kp, vp, gp, outp = padded
    got = fa.flash_attention_bwd_ref(qp, kp, vp, tab, mask, outp, lse, gp, **kw)
    tight = dict(rtol=1e-12, atol=1e-12)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a[..., :d], r, **tight, msg=name)
        assert not a[..., d:].any(), name
    torch.testing.assert_close(got[3], want[3], **tight)


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_bf16_d256_forward_plans_visit_each_attended_tile_once_a_row(label, b, h, hk, n, m,
                                                                     causal, d):
    """bf16's K1 at D = 256 (192 padded to it), the rows form: blocks of 128
    query rows, two consumers on a 64-row half each, two stages, one block
    an SM. Each query row's consumer visits every key tile the row attends
    once, in order, and none past the keys; a block's ring carries the key
    tiles up to its later half's causal end (the kernel's `ntiles`), which
    no half of it exceeds."""
    plan = fa.fwd_plan(b, h, n, m, causal, torch.bfloat16, d)
    assert (plan["rows"], plan["consumers"], plan["stages"], plan["blocks"],
            plan["slices"]) == (128, 2, 2, 1, 1)
    assert plan["grid"] == (b * h, -(-n // 128))
    key_tiles = -(-m // 64)
    keep = np.tril(np.ones((n, m), bool), m - n) if causal else np.ones((n, m), bool)
    attended = np.stack([keep[:, ki * 64:(ki + 1) * 64].any(1) for ki in range(key_tiles)], 1)
    visits = np.zeros((n, key_tiles), int)
    for qi, (keys, second) in plan["tiles"].items():
        assert not second and keys == sorted(keys) and all(ki < key_tiles for ki in keys)
        visits[qi * 64:(qi + 1) * 64, keys] += 1
    assert visits.max() == 1 and (visits[attended] == 1).all()
    for blk in range(plan["grid"][1]):
        q0 = 128 * blk
        kv_end = min(m, q0 + 128 + m - n) if causal else m
        halves = [plan["tiles"][i][0] for i in (2 * blk, 2 * blk + 1) if i in plan["tiles"]]
        assert max(len(keys) for keys in halves) == -(-kv_end // 64)


@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_bf16_d256_forward_plan_fits_the_card(label, b, h, hk, n, m, causal):
    """K1's rows form at bf16's D = 256: two Q tiles 64 KB, two stages of K
    and V 128 KB, each stage's table slice (191 of 256 floats), key flags
    and two words 1,296 bytes, the barriers 128: 199,328 bytes, one block an
    SM."""
    plan = fa.fwd_plan(b, h, n, m, causal, torch.bfloat16, 256)
    assert plan["smem"] == 2 * 32768 + 2 * (2 * 32768 + 1296) + 128 == 199328
    assert plan["smem"] <= fa.SMEM_LIMIT and plan["blocks"] * (plan["smem"] + 1024) <= SM_SMEM


def emulate_rows_form(q, k, v, tab, bias, mask, causal, scale):
    """K1's rows form in float64, as csrc/flash_fwd.cu walks it: blocks of
    128 query rows, the last block first; the producer's table slice of a
    key tile, Bs[i] = tab[q0 - k0 - 63 + i + n - 1] for i < 191 (zero
    outside the table), read by the consumer of half c at 64 c + r - j + 63
    for its row r and key j of the tile; each half's online softmax over the
    key tiles up to its own rows' causal end, in order (a half past N
    computes nothing); the (H, N, M) bias, key flags and causal mask as the
    kernel adds them. Returns out, lse."""
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    group = h // hk
    out = torch.zeros_like(q)
    lse = torch.zeros(b, h, n, dtype=q.dtype)
    for bh in range(b * h):
        bi, head = divmod(bh, h)
        kv = head // group
        for blk in reversed(range(-(-n // 128))):
            q0 = 128 * blk
            for c in range(2):
                qc = q0 + 64 * c
                if qc >= n:
                    continue
                rows = torch.arange(qc, min(n, qc + 64))
                own = min(m, qc + 64 + m - n) if causal else m
                mx = torch.full((len(rows),), -1e30, dtype=q.dtype)
                l = torch.zeros_like(mx)
                o = torch.zeros(len(rows), d, dtype=q.dtype)
                for k0 in range(0, own, 64):
                    keys = torch.arange(k0, min(m, k0 + 64))
                    s = scale * q[bi, head, rows] @ k[bi, kv, keys].T
                    if tab is not None:
                        idx = q0 - k0 - 63 + torch.arange(191) + n - 1
                        inside = (idx >= 0) & (idx < 2 * n - 1)
                        slice_ = torch.where(inside, tab[idx.clamp(0, 2 * n - 2), head],
                                             torch.zeros((), dtype=q.dtype))
                        at = 64 * c + (rows - qc)[:, None] - (keys - k0)[None, :] + 63
                        s = s + slice_[at]
                    if bias is not None:
                        s = s + (bias[bi, head] if bias.ndim == 4 else bias[head])[rows][:, keys]
                    allowed = mask[bi, keys][None, :].expand(len(rows), -1)
                    if causal:
                        allowed = allowed & (keys[None, :] <= rows[:, None] + m - n)
                    s = s.masked_fill(~allowed, -1e30)
                    m_new = torch.maximum(mx, s.max(1).values)
                    alpha, p_ = torch.exp(mx - m_new), torch.exp(s - m_new[:, None])
                    l, mx = l * alpha + p_.sum(1), m_new
                    o = o * alpha[:, None] + p_ @ v[bi, kv, keys]
                out[bi, head, rows] = o / l[:, None]
                lse[bi, head, rows] = mx + torch.log(l)
    return out, lse


@pytest.mark.parametrize("form,n,m,causal", [("table", 200, 200, True),
                                             ("bias", 150, 150 + 17, True),
                                             ("batch", 70, 70, True),
                                             ("none", 130, 77, False),
                                             ("none", 1, 17, False)],
                         ids=["table", "prefix", "per-batch", "cross", "decode"])
def test_rows_form_scheme_equals_the_plain_version(form, n, m, causal):
    """K1's rows form at bf16's D = 256 (`emulate_rows_form`: the 128-row
    blocks, each half's own causal end, the table slice of 191 entries read
    at the half's offset), in float64 at D = 256 (2 x 4 heads over one kv
    head; one batch row's keys partly masked), equals the plain forward to
    1e-12 in the table, prefix (causal over 17 more keys, an (H, N, M)
    bias), per-batch bias, cross (77 keys) and decode (n = 1) forms, with
    ragged N: the walk and the slice's addressing change no result."""
    b, h, hk, d = 2, 4, 1, 256
    rng = np.random.default_rng(n + m)
    q = torch.from_numpy(rng.normal(size=(b, h, n, d)))
    k, v = (torch.from_numpy(rng.normal(size=(b, hk, m, d))) for _ in range(2))
    tab = torch.from_numpy(0.5 * rng.normal(size=(2 * n - 1, h))) if form == "table" else None
    bias = torch.from_numpy(0.5 * rng.normal(size=(h, n, m))) if form == "bias" else \
        torch.from_numpy(0.5 * rng.normal(size=(b, h, n, m))) if form == "batch" else None
    mask = torch.ones(b, m, dtype=torch.bool)
    mask[1, (2 * m) // 3:] = False
    scale = d ** -0.5
    got = emulate_rows_form(q, k, v, tab, bias, mask, causal, scale)
    want = fa.flash_attention_ref(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                  causal=causal, scale=scale, return_lse=True)
    for name, a, r in zip(("out", "lse"), got, want):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12, msg=name)


@pytest.mark.parametrize("d", [129, 160, 200, 255])
def test_bf16_forward_padding_to_256_is_exact(d):
    """What the CUDA wrapper does with a bf16 head dim from 129 to 255 in the
    forward, through the plain forward in float64: q, k and v zero-padded to
    256 (`flash_head_dim`), the true D's scale, the output sliced back,
    equal the unpadded plain forward's out and lse to 1e-12, and the padded
    output columns are zeros; with the table (causal, a key mask) and with
    an (H, N, M) bias over a prefix of 9 more keys."""
    b, h, hk, n = 2, 2, 1, 70
    rng = np.random.default_rng(d)
    dn = fa.flash_head_dim(d, torch.bfloat16)
    assert dn == 256
    for m, form in ((n, "table"), (n + 9, "bias")):
        q = torch.from_numpy(rng.normal(size=(b, h, n, d)))
        k, v = (torch.from_numpy(rng.normal(size=(b, hk, m, d))) for _ in range(2))
        extra = dict(bias_tab=torch.from_numpy(0.5 * rng.normal(size=(2 * n - 1, h))))
        if form == "bias":
            extra = dict(bias=torch.from_numpy(0.5 * rng.normal(size=(h, n, m))))
        mask = torch.ones(b, m, dtype=torch.bool)
        mask[1, 50:] = False
        kw = dict(key_mask=mask, causal=True, scale=d ** -0.5, return_lse=True, **extra)
        want = fa.flash_attention_ref(q, k, v, **kw)
        padded = fa._padded(q, k, v, d=dn)
        assert all(x.shape[-1] == 256 for x in padded)
        got = fa.flash_attention_ref(*padded, **kw)
        tight = dict(rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got[0][..., :d], want[0], **tight, msg=form)
        assert not got[0][..., d:].any(), form
        torch.testing.assert_close(got[1], want[1], **tight, msg=form)


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_f32_d256_backward_plans_visit_each_attended_tile_once(label, b, h, hk, n, m, causal,
                                                               d):
    """float32's K2 and K3 at D = 256 (192 padded to it), the chunked forms:
    K2 one consumer, two stages, 12 ring items a key tile (K's, V's, K's
    four 64-column chunks), its key tiles up to the diagonal in order, each
    attended (query tile, key tile) once; K3 the chunked pair form, whose two
    consumers take every item of the block between them (one for dk, one
    for dv), 16 ring items an item (Q's, dO's, then both again in turns),
    each attended (query head, query row) of
    the kv head once over the cluster's ranks and the query chunks."""
    f32 = torch.float32
    for dbias in (False, True):
        dq = fa.dq_plan(b, h, hk, n, m, causal, f32, dbias=dbias, d=d)
        assert (dq["slices"], dq["stages"], dq["items"], dq["blocks"]) == (1, 2, 12, 1)
        assert dq["grid"] == (b, h, -(-n // 64))
        seen = collections.Counter()
        for qi, keys in dq["tiles"].items():
            assert keys == sorted(keys)
            seen.update((qi, ki) for ki in keys)
        assert max(seen.values()) == 1 and set(seen) >= attended_tiles(n, m, causal)
        assert all(ki * 64 < m for _, ki in seen)
    dkv = fa.dkv_plan(b, h, hk, n, m, f32, d)
    assert (dkv["slices"], dkv["consumers"], dkv["pair"], dkv["stages"], dkv["items"],
            dkv["blocks"]) == (1, 2, True, 2, 16, 1)
    keep = np.tril(np.ones((n, m), bool), m - n) if causal else np.ones((n, m), bool)
    group = h // hk
    for kv_head in range(hk):
        for ki in range(-(-m // 64)):
            sees = keep[:, ki * 64:(ki + 1) * 64].any(1)
            rows = np.zeros((h, n), int)
            for rank in range(dkv["cluster"]):
                for z in range(dkv["qsplit"]):
                    first, second = fa.dkv_items(dkv, h, hk, n, m, causal, kv_head, ki, rank, z)
                    assert not second
                    for head, q0 in first:
                        rows[head, q0:q0 + 64] += 1
            heads = list(range(kv_head * group, (kv_head + 1) * group))
            assert rows.max() == 1 and (rows[heads][:, sees] == 1).all()
            assert not rows[[x for x in range(h) if x not in heads]].any()


@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_f32_d256_backward_plans_fit_the_card(label, b, h, hk, n, m, causal):
    """K2's chunked block at float32's D = 256: Q and dO unsplit 128 KB, two
    stages of a 64-column chunk with its small parts 64 KB, two key tiles'
    table slices and flags 1,568 bytes, the barriers 256 (198,432), then
    K4's buffers (223,008 bytes) or K5's two dS buffers (231,200: 1,248
    bytes under the 232,448 a block may have); K3's chunked pair form: K and
    V unsplit, the two stages, two items' lse, Delta and table slices, the
    flags, P^T and dS^T as float32, the barriers: 231,824 (624 under). One
    block an SM each."""
    f32 = torch.float32
    with_k4 = fa.dq_plan(b, h, hk, n, m, causal, f32, d=256)
    with_k5 = fa.dq_plan(b, h, hk, n, m, causal, f32, dbias=True, d=256)
    dkv = fa.dkv_plan(b, h, hk, n, m, f32, 256)
    assert (with_k4["smem"], with_k5["smem"], dkv["smem"]) == (223008, 231200, 231824)
    assert 2 * 65536 + 2 * 32768 + 2 * 784 + 256 == 223008 - fa._K4_BYTES
    assert 2 * 65536 + 2 * 32768 + 2 * 1024 + 272 + 2 * 16384 + 128 == 231824
    assert (fa.SMEM_LIMIT - with_k5["smem"], fa.SMEM_LIMIT - dkv["smem"]) == (1248, 624)
    for plan in (with_k4, with_k5, dkv):
        assert plan["blocks"] == 1 and plan["smem"] + 1024 <= SM_SMEM


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("label,b,h,hk,n,m,causal", SHAPES, ids=[s[0] for s in SHAPES])
def test_f32_d256_backward_keeps_the_cluster_and_query_split_rules(label, b, h, hk, n, m,
                                                                   causal, d):
    """K5's cluster (the largest divisor of the batch up to 8, atomics past
    one cluster a tile) and K3's cluster are those of every native head dim;
    K3's query split too, but under two blocks an SM (its blocks are few
    and long, one an SM), where the chunked form splits further, into
    chunks of at least 2 query tiles, so that its grid reaches two blocks
    an SM where the query tiles allow."""
    f32 = torch.float32
    for batch in (b, 3, 9, 12):
        got = fa.dq_plan(batch, h, hk, n, m, causal, f32, dbias=True, d=d)
        want = fa.dq_plan(batch, h, hk, n, m, causal, f32, dbias=True)
        assert (got["cluster"], got["atomic"], got["grid"], got["tiles"]) == (
            want["cluster"], want["atomic"], want["grid"], want["tiles"])
    got, want = fa.dkv_plan(b, h, hk, n, m, f32, d), fa.dkv_plan(b, h, hk, n, m, f32)
    assert got["cluster"] == want["cluster"]
    base = got["cluster"] * b * hk * -(-m // 64)
    if base >= 2 * fa.PLAN_SMS:
        assert got["qsplit"] == want["qsplit"] == 1
    else:
        qtiles = -(-n // 64)
        assert got["qsplit"] == max(want["qsplit"], min(-(-2 * fa.PLAN_SMS // base), qtiles // 2))
        assert got["qsplit"] == 1 or qtiles // got["qsplit"] >= 2
    assert got["grid"] == (got["cluster"], b * hk, -(-m // 64) * got["qsplit"])


def emulate_chunked(q, k, v, g, mask, causal, scale, dq_plan, dkv_plan):
    """float32's chunked K2 and K3 at D = 256, in the inputs' dtype, from a
    plain forward's lse: the depth in 64-column chunks, S (S^T) and dP (dP^T)
    summed over the chunks in order; K2 per query tile over its key tiles in
    the plan's order, each tile's dS K from zero and added, one 64-column
    chunk of dq at a time; K3's pair form per block: the dk consumer forms
    P^T and hands it over, the dv consumer takes dO's chunks for dP^T and
    hands dS^T back, then the two take the transposed chunks in turns, one
    64-column chunk of dK += dS^T Q and of dV += P^T dO each; each
    consumer's sum over the block's items in order, then the cluster's
    blocks in rank order, then the query chunks in order, dk (and dq)
    scaled at the end. Returns dq, dk, dv."""
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    chunks = [slice(c, c + 64) for c in range(0, d, 64)]
    out, lse = fa.flash_attention_ref(q, k, v, key_mask=mask, causal=causal, scale=scale,
                                      return_lse=True)
    delta = (g * out).sum(-1)
    keep = torch.ones(n, m, dtype=torch.bool)
    keep = keep.tril(m - n) if causal else keep

    def tile(bi, head, kv, qs, ks):
        allowed = keep[qs, ks] & mask[bi, ks][None, :]
        s = sum((q[bi, head, qs, c] @ k[bi, kv, ks, c].T for c in chunks[1:]),
                q[bi, head, qs, chunks[0]] @ k[bi, kv, ks, chunks[0]].T)
        p = torch.exp((scale * s).masked_fill(~allowed, -1e30) - lse[bi, head, qs, None])
        return p, allowed

    dq = torch.zeros_like(q)
    for bi in range(b):
        for head in range(h):
            kv = head // (h // hk)
            for qi, keys in dq_plan["tiles"].items():
                qs = slice(qi * 64, min(n, qi * 64 + 64))
                acc = torch.zeros(qs.stop - qs.start, d, dtype=q.dtype)
                for ki in keys:
                    ks = slice(ki * 64, min(m, ki * 64 + 64))
                    p, _ = tile(bi, head, kv, qs, ks)
                    dp = sum((g[bi, head, qs, c] @ v[bi, kv, ks, c].T for c in chunks[1:]),
                             g[bi, head, qs, chunks[0]] @ v[bi, kv, ks, chunks[0]].T)
                    ds = p * (dp - delta[bi, head, qs, None])
                    for c in chunks:
                        acc[:, c] = acc[:, c] + ds @ k[bi, kv, ks, c]
                dq[bi, head, qs] = scale * acc
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for kv_head in range(hk):
            for ki in range(-(-m // 64)):
                ks = slice(ki * 64, min(m, ki * 64 + 64))
                by_chunk = []
                for z in range(dkv_plan["qsplit"]):
                    by_rank = []
                    for rank in range(dkv_plan["cluster"]):
                        items, rest = fa.dkv_items(dkv_plan, h, hk, n, m, causal, kv_head, ki,
                                                   rank, z)
                        assert not rest
                        sk = torch.zeros(ks.stop - ks.start, d, dtype=q.dtype)  # consumer A
                        sv = torch.zeros_like(sk)  # consumer B
                        for head, q0 in items:
                            qs = slice(q0, min(n, q0 + 64))
                            pt = tile(bi, head, kv_head, qs, ks)[0].T  # A: P^T, handed to B
                            dpt = torch.zeros_like(pt)
                            for c in chunks:  # B: dO's chunks
                                dpt = dpt + v[bi, kv_head, ks, c] @ g[bi, head, qs, c].T
                            dst = pt * (dpt - delta[bi, head, qs][None, :])  # B: dS^T, to A
                            for c in chunks:  # Q's and dO's chunks again, in turns
                                sk[:, c] = sk[:, c] + dst @ q[bi, head, qs, c]
                                sv[:, c] = sv[:, c] + pt @ g[bi, head, qs, c]
                        by_rank.append((sk, sv))
                    by_chunk.append((sum(x[0] for x in by_rank[1:]) + by_rank[0][0],
                                     sum(x[1] for x in by_rank[1:]) + by_rank[0][1]))
                dk[bi, kv_head, ks] = scale * (sum(x[0] for x in by_chunk[1:]) + by_chunk[0][0])
                dv[bi, kv_head, ks] = sum(x[1] for x in by_chunk[1:]) + by_chunk[0][1]
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
def test_k3_chunked_pair_form_sum_order_matches_jax(causal):
    """float32's chunked K2 and K3 at D = 256 (`emulate_chunked`: the depth
    in 64-column chunks, K3's P^T and dS^T handed between its consumers
    and its dK and dV chunks taken in turns,
    each consumer's sum over the items in order, then the cluster's ranks in
    rank order, then the query chunks in order), emulated in float64 with
    the plan's query split forced on (2 x 4 heads x 130 queries over one kv
    head, 17 keys or a causal prefix of 17 more, one batch row's keys half
    masked): the plain float64 backward's dq, dk, dv to 1e-12, and JAX's
    gradients of `attend` to its tolerance."""
    b, h, hk, n, d = 2, 4, 1, 130, 256
    m = 17 if not causal else n + 17
    rng = np.random.default_rng(4)
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, m, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, m, d)).astype(np.float32)
    g = rng.normal(size=(b, h, n, d)).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[1, m // 2:] = False
    scale = d ** -0.5
    f32 = torch.float32
    dkv = dict(fa.dkv_plan(b, h, hk, n, m, f32, d), qsplit=2)
    assert dkv["pair"] and dkv["items"] == 16 and dkv["cluster"] == 4
    dq_plan = fa.dq_plan(b, h, hk, n, m, causal, f32, d=d)
    assert dq_plan["items"] == 12
    x64 = [torch.from_numpy(a.astype(np.float64)) for a in (q, k, v, g)]
    mask_t = torch.from_numpy(mask)
    dq, dk, dv = emulate_chunked(*x64, mask_t, causal, scale, dq_plan, dkv)
    out, lse = fa.flash_attention_ref(*x64[:3], key_mask=mask_t, causal=causal, scale=scale,
                                      return_lse=True)
    want = fa.flash_attention_bwd_ref(*x64[:3], None, mask_t, out, lse, x64[3], causal=causal,
                                      scale=scale)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12, msg=name)

    def f(q_, k_, v_):
        kr, vr = (jnp.repeat(a, h // hk, axis=1) for a in (k_, v_))
        return attend(q_, kr, vr, mask=jnp.asarray(mask)[:, None, None, :], causal=causal,
                      scale=scale)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(g))
    for a, r in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **GRAD_TOL)


@pytest.mark.parametrize("d", [160, 200])
def test_f32_backward_padding_to_256_is_exact(d):
    """What the CUDA wrapper does with a float32 head dim from 129 to 255 in
    the backward, through the plain backward in float64: q, k, v, out and dO
    zero-padded to 256 (`flash_head_dim(d, dtype, "K2")`; K1 keeps
    `native_head_dim`'s 192 or 256, column-sliced), the true D's scale, the
    gradients sliced back, equal the unpadded plain backward's to 1e-12, and
    their padded columns are zeros: dq, dk, dv and the bias's gradient, with
    the table (causal, a key mask) and with an (H, N, M) bias over a prefix
    of 9 more keys."""
    b, h, hk, n = 2, 2, 1, 70
    rng = np.random.default_rng(d)
    dn = fa.flash_head_dim(d, torch.float32, "K2")
    assert dn == fa.flash_head_dim(d, torch.float32, "K3") == 256
    assert fa.flash_head_dim(d, torch.float32) == fa.native_head_dim(d)  # K1's, column-sliced
    for m, form in ((n, "table"), (n + 9, "bias")):
        q, g = (torch.from_numpy(rng.normal(size=(b, h, n, d))) for _ in range(2))
        k, v = (torch.from_numpy(rng.normal(size=(b, hk, m, d))) for _ in range(2))
        tab = bias = None
        if form == "table":
            tab = torch.from_numpy(0.5 * rng.normal(size=(2 * n - 1, h)))
        else:
            bias = torch.from_numpy(0.5 * rng.normal(size=(h, n, m)))
        mask = torch.ones(b, m, dtype=torch.bool)
        mask[1, 50:] = False
        kw = dict(causal=True, scale=d ** -0.5)
        out, lse = fa.flash_attention_ref(q, k, v, bias_tab=tab, bias=bias, key_mask=mask,
                                          return_lse=True, **kw)
        want = fa.flash_attention_bwd_ref(q, k, v, tab, mask, out, lse, g, bias=bias, **kw)
        padded = fa._padded(q, k, v, g, out, d=dn)
        assert all(x.shape[-1] == 256 for x in padded)
        qp, kp, vp, gp, outp = padded
        got = fa.flash_attention_bwd_ref(qp, kp, vp, tab, mask, outp, lse, gp, bias=bias, **kw)
        tight = dict(rtol=1e-12, atol=1e-12)
        for name, a, r in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a[..., :d], r, **tight, msg=f"{form} {name}")
            assert not a[..., d:].any(), f"{form} {name}"
        torch.testing.assert_close(got[3], want[3], **tight, msg=f"{form} bias gradient")
