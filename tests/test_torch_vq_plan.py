"""The launch plan of the nearest-code search K6, as
`ops/kernels/vq.py::vq_plan` states it for the C launcher: every (row tile,
code tile, chunk of 32 dimensions) is taken by exactly one block, at the
row counts the port's paths give K6 (1, 7, 192, 400, 800 and 1300 rows of
512 against 1024 codes, EnCodec's 1200 rows of 128) and at the odd shapes
of the GPU tests; the plan fills the card at 1 and 192 rows and keeps the
merged row tiles within the kernel's scratch; and a plain emulation of
the kernel's order (each chunk's product from zero, the ranks' partial
scores added in rank order, the minima by (score, index) over the code
groups) picks the Pallas kernel's codes (`ops/pallas/vq.py::
vq_nearest_code` in interpret mode).

Tolerance: indices identical (the inputs hold no near ties)."""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolm_pytorch_tpu.ops.pallas import vq as jvq

from audiolm_pytorch_tpu_torch.ops.kernels import vq

import torch_port_util  # noqa: F401  (one torch thread a test worker)

# (rows, codes, dim): the port's paths, then the GPU tests' odd shapes
SHAPES = [(1, 1024, 512), (7, 1024, 512), (192, 1024, 512), (400, 1024, 512),
          (600, 1024, 512), (800, 1024, 512), (1300, 1024, 512), (1200, 1024, 128),
          (37, 100, 33), (130, 64, 16), (50, 300, 64), (20, 1100, 40), (65, 1024, 30)]


@pytest.mark.parametrize("n,c,d", SHAPES, ids=[f"{n}x{c}x{d}" for n, c, d in SHAPES])
def test_k6_plan_covers_each_row_code_and_dimension_once(n, c, d):
    plan = vq.vq_plan(n, c, d)
    ksplit, groups, row_tiles = plan["grid"]
    assert ksplit in (1, 2, 4, 8) and ksplit <= plan["chunks"]
    assert plan["chunks"] * 32 >= -(-d // 4) * 4 > (plan["chunks"] - 1) * 32
    assert row_tiles * 64 >= n > (row_tiles - 1) * 64
    seen = collections.Counter()
    for rt in range(row_tiles):
        for g in range(groups):
            for rank in range(ksplit):
                rows, codes, dims = vq.vq_block_work(plan, c, rank, g, rt)
                assert codes == sorted(codes) and dims == sorted(dims)
                assert dims, "every rank takes a chunk"
                if ksplit > 1:
                    assert len(codes) == 1, "split dimensions: one code tile a block"
                seen.update((rows.start, c0, k0) for c0 in codes for k0 in dims)
    want = {(r0, c0, k0) for r0 in range(0, n, 64) for c0 in range(0, c, 64)
            for k0 in range(0, d, 32)}
    assert set(seen) == want and max(seen.values()) == 1


@pytest.mark.parametrize("n", [1, 7, 192])
def test_k6_plan_fills_the_card_at_few_rows(n):
    ksplit, groups, row_tiles = vq.vq_plan(n, 1024, 512)["grid"]
    assert ksplit * groups * row_tiles >= 100


@pytest.mark.parametrize("n,c,d", SHAPES + [(5000, 1024, 512), (100, 65536, 256)],
                         ids=[f"{n}x{c}x{d}" for n, c, d in SHAPES + [(5000, 1024, 512),
                                                                      (100, 65536, 256)]])
def test_k6_plan_keeps_merged_rows_within_the_scratch(n, c, d):
    # with more than one group a row tile, the groups' minima meet in static
    # scratch of 2 x 132 (row tile, group) slots and 132 tickets
    ksplit, groups, row_tiles = vq.vq_plan(n, c, d)["grid"]
    if groups > 1:
        assert row_tiles <= vq.PLAN_SMS and row_tiles * groups <= 2 * vq.PLAN_SMS


def emulate(x, cb, plan):
    """K6's picks as its blocks compute them, in float32: per block and
    chunk x.e from zero, added chunk by chunk; |e|^2 per code in the same
    chunks; with the dimensions split, the ranks' partials added in rank
    order; scores -2 x.e + |e|^2, each row's (score, index) minimum over
    its group's codes, then over the groups."""
    n, d = x.shape
    c = cb.shape[0]
    ksplit, groups, row_tiles = plan["grid"]
    d4 = -(-d // 4) * 4
    xp = torch.zeros(n, d4)
    xp[:, :d] = x
    ep = torch.zeros(c, d4)
    ep[:, :d] = cb
    best = torch.full((n, 2), float("inf"))
    best[:, 1] = 2 ** 31 - 1
    for rt in range(row_tiles):
        for g in range(groups):
            xe_ranks, e2_ranks = [], []
            for rank in range(ksplit):
                rows, codes, dims = vq.vq_block_work(plan, c, rank, g, rt)
                rows = range(rows.start, min(rows.stop, n))
                xe = torch.zeros(len(rows), len(codes) * 64)
                e2 = torch.zeros(len(codes) * 64)
                for k0 in dims:
                    xs = xp[rows.start:rows.stop, k0:k0 + 32]
                    es = torch.cat([torch.nn.functional.pad(ep[c0:c0 + 64, k0:k0 + 32],
                                                            (0, 0, 0, 64 - len(ep[c0:c0 + 64])))
                                    for c0 in codes])
                    xe = xe + xs @ es.T
                    e2 = e2 + es.square().sum(-1)
                xe_ranks.append(xe)
                e2_ranks.append(e2)
            xe, e2 = xe_ranks[0], e2_ranks[0]
            for a, b in zip(xe_ranks[1:], e2_ranks[1:]):
                xe, e2 = xe + a, e2 + b
            code_ids = torch.tensor([c0 + i for c0 in codes for i in range(64)])
            scores = (-2 * xe + e2).masked_fill(code_ids >= c, float("inf"))
            for i, r in enumerate(rows):
                s = scores[i].min()
                idx = code_ids[scores[i] == s].min()
                if s < best[r, 0] or (s == best[r, 0] and idx < best[r, 1]):
                    best[r] = torch.stack([s, idx.float()])
    return best[:, 1].to(torch.int32)


@pytest.mark.parametrize("n,c,d", [(70, 300, 100), (3, 200, 512), (150, 130, 36)])
def test_k6_plans_order_picks_the_pallas_kernels_codes(n, c, d):
    rng = np.random.default_rng(n)
    cb = rng.normal(size=(c, d)).astype(np.float32)
    x = (cb[rng.integers(0, c, size=n)] + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    plan = vq.vq_plan(n, c, d)
    got = emulate(torch.from_numpy(x), torch.from_numpy(cb), plan)
    want = np.asarray(jvq.vq_nearest_code(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
