"""Flash attention, forward and backward: the wrappers of the hand-written
Hopper kernels `csrc/flash_fwd.cu` and `csrc/flash_bwd.cu`, the
`torch.autograd.Function` that joins them, and their plain PyTorch versions.

Replaces the JAX package's Pallas kernels in `ops/pallas/flash_attention.py`:
the forward `_kernel`, and the backward `_dq_kernel`, `_dkv_kernel`,
`_dblocks_kernel` and `_dbias_kernel` behind its `jax.custom_vjp`: the
backward is two launches, dq (K2, which also gives the bias's gradient, K4
or K5) and dk/dv (K3). The bias comes in one of two forms. The Semantic
LM's rel-pos bias is its (2N-1, H) distance table, read inside the kernels'
tiles as bias[h, q, k] = tab[q - k + N - 1, h]; its gradient is reduced
along the diagonals straight into a (2N-1, H) table, and the (H, N, N) bias
is never built. The Coarse and Fine LMs' bias is a materialised (H, N, M)
float tensor shared over the batch: each tile reads its (64, 64) block of
bias[h], and K2's launch gives its gradient, the batch sum of dS over a
thread-block cluster of the batch rows. A per-batch (B, H, N, M) bias is
read the same way at bias[b, h], and K2's launch writes its gradient, dS
itself, straight to dbias[b, h] (the JAX package takes that gradient from
a chunked XLA recurrence). The grids are one-dimensional, so no extent of
B, H, N or M is limited but by the grid's 2^31 - 1 blocks. On a CUDA tensor
the wrappers launch the kernels or raise; only a CPU tensor takes the plain
versions.

Head dims. The kernels take every D. They are built for D = 32, 64 and 128
(`HEAD_DIMS`), and over 128 they run a column-sliced form of their own for
any multiple of 64 (`WIDE_CHUNK`): a block owns one 64-wide slice of the
output's columns and recomputes S (and dP) over the whole depth, 64 columns
at a time, so no tile grows with D. They have one more native head dim,
256, where S (and dP) are formed once a tile: in bf16 (`BF16_DIM`) K1, K2
and K3 run their Hopper forms there; in float32 (`F32_DIM`) K2 and K3 run
their chunked Hopper forms (the streamed operands 64 columns at a time),
while float32's K1 keeps the column-sliced form over 128. So the backward's
head dim differs from the forward's in float32. On a CUDA tensor any other
D goes through the next head dim its kernel has (`flash_head_dim`, the one
rule of K1, K2 and K3, the kernel an argument): q, k and v (and in the
backward out and dO) are zero-padded along D, the scale stays D ** -0.5 of
the true D, and the output and the gradients are sliced back. That is exact (a zero column
adds nothing to q.k and gives a zero output column) and it is the kernel
that runs, counted as its launch.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..relpos import toeplitz_expand
from ._build import built_with, load

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_bwd",
           "flash_attention_bwd_ref", "fwd", "bwd_dq", "bwd_dkv", "built_with", "SOURCE",
           "SOURCE_BWD", "HEAD_DIMS", "launches", "launches_dq", "launches_dkv",
           "launches_dtab", "launches_dbias", "launches_dbias_per_batch", "PLAN_SMS", "fwd_plan", "dq_plan", "dkv_plan",
           "dkv_items", "fwd_plan_built", "dq_plan_built", "dkv_plan_built", "native_head_dim",
           "flash_head_dim", "SMEM_LIMIT", "WIDE_CHUNK", "BF16_DIM", "F32_DIM"]

SOURCE = "flash_fwd.cu"
SOURCE_BWD = "flash_bwd.cu"
HEAD_DIMS = (32, 64, 128)  # the head dims of the kernels' native forms; others up to 128 padded
WIDE_CHUNK = 64  # over 128: the column-sliced forms' chunk and slice (D a multiple of it)
BF16_DIM = 256  # bf16's K1, K2 and K3 run their Hopper forms at this head dim too
F32_DIM = 256  # float32's K2 and K3 run their chunked Hopper forms at this head dim too
_KERNELS = ("K1", "K2", "K3")
_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches of each kernel, counted where it is launched
launches = 0       # forward (K1)
launches_dq = 0    # dq (K2)
launches_dkv = 0   # dk, dv (K3; with its query range split, its second pass is the same call)
launches_dtab = 0  # bias-table gradient (K4: partial sums in K2's launch, then its second pass)
launches_dbias = 0  # (H, N, M) bias gradient (K5, fused into K2's launch)
launches_dbias_per_batch = 0  # (B, H, N, M) bias gradient (dS, written in K2's launch)
# K5's cluster holds at most this many batch rows; beyond it the clusters of
# one tile add their partial sums by atomics into a zeroed dbias
_MAX_CLUSTER = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# The launch plans of K1, K2 and K3, as their C launchers compute them from
# the sizes (csrc/flash_fwd.cu `launch`, csrc/flash_bwd.cu `dq_plan` and
# `dkv_plan`): pure functions, so the CPU tests can check what the card runs.
PLAN_SMS = 132  # the H100's SMs, which the plans fill
SMEM_LIMIT = 232448  # the shared memory one block may have on the H100
_TILE = 64      # query rows and keys per tile of both kernels
_MAX_DKV_CLUSTER = 8
_MISC_FWD = (128 + 64 + 4) * 4  # a stage's table slice, key flags and two words (K1, K2)
_MISC_ROWS = (256 + 64 + 4) * 4  # the same for K1's 128-row block (bf16 at D = 256)
_MISC_DKV = (64 + 64 + 128) * 4  # a stage's lse, Delta and table slice (K3)
_K4_BYTES = (64 * 80 + 2 * 4 * 128) * 4  # K2's skewed dS rows and delta slots
_K5_BYTES = 2 * 64 * 64 * 4  # K2's two dS buffers of K5's batch sum
_PAIR_BYTES = 64 * 64 * 4 + 64 * 64 * 2  # bf16 K3 at 256: P^T (float32) and dS^T (bf16) handed over
_CHUNK_STAGE = 2 * 64 * 64 * 4  # float32 at 256: a streamed 64-column chunk and its small parts
_CHUNK_FIXED = 2 * 64 * F32_DIM * 4  # float32 at 256: K2's Q and dO (K3's K and V), unsplit
_CHUNK_ITEMS = F32_DIM // 64  # float32 at 256: a 64-row operand's chunks (ring items)


def _tiles(x):
    return -(-x // _TILE)


def native_head_dim(d):
    """The head dim of K7 (and of the flash kernels in float32) for a D-wide
    head: up to 128, D where it is one of HEAD_DIMS, else the next larger;
    over 128, D rounded up to a multiple of WIDE_CHUNK (the column-sliced
    forms). q, k and v are zero-padded to it."""
    if d < 1:
        raise ValueError(f"head dim {d}: the kernels take head dims of 1 and more")
    for native in HEAD_DIMS:
        if d <= native:
            return native
    return -(-d // WIDE_CHUNK) * WIDE_CHUNK


def _hopper_256(dtype, kernel):
    """Whether `kernel` has a Hopper form at D = 256 in this dtype: all
    three in bf16, K2 and K3 in float32."""
    if kernel not in _KERNELS:
        raise ValueError(f"kernel {kernel!r}: one of {_KERNELS}")
    return dtype == torch.bfloat16 or kernel != "K1"


def flash_head_dim(d, dtype, kernel="K1"):
    """The head dim at which the flash kernel `kernel` ("K1" the forward,
    "K2" dq, "K3" dk and dv) runs a D-wide head: `native_head_dim`'s, but
    every D from 129 to 256 goes to 256 where the kernel has a Hopper form
    there (K1, K2 and K3 in bf16; K2 and K3 in float32, whose K1 keeps the
    column-sliced form over 128). Over 256 every kernel keeps the
    column-sliced form. q, k, v (and in the backward out and dO) are
    zero-padded to it."""
    top = BF16_DIM if dtype == torch.bfloat16 else F32_DIM
    if _hopper_256(dtype, kernel) and HEAD_DIMS[-1] < d <= top:
        return top
    return native_head_dim(d)


def _slices(d, dtype, kernel="K1"):
    """The output slices a block of `kernel` owns one of: D / 64 in the
    column-sliced forms (over 256; float32's K1 over 128), else one."""
    top = BF16_DIM if dtype == torch.bfloat16 else F32_DIM
    wide = d > (top if _hopper_256(dtype, kernel) else HEAD_DIMS[-1])
    return native_head_dim(d) // WIDE_CHUNK if wide else 1


def _wide_smem(dtype):
    """The column-sliced forms' ring: two stages of two 64 x 64 tiles, each
    row padded by 16 bytes (csrc/mma.cuh's tc::Wide)."""
    esize = 4 if dtype == torch.float32 else 2
    return 4 * 64 * (64 + 16 // esize) * esize


def _operand_bytes(d, dtype):
    """One 64-row operand tile of D-wide rows in shared memory, with its
    tf32 small parts in float32: 128-byte boxes, a 32-wide bf16 row taking
    a whole one (csrc/wgmma.cuh)."""
    f32 = dtype == torch.float32
    tile = 8192 * max(1, d * (4 if f32 else 2) // 128)
    return 2 * tile if f32 else tile


def fwd_plan(b, h, n, m, causal, dtype=torch.float32, d=64):
    """K1's launch: grid (b*h, query blocks of `rows` query rows); its
    consumer warpgroups a block, two (which take the key tiles in turn, the
    second's softmax state merged into the first's at the end) for float32
    over more than one key tile and for bf16 grids under two blocks an SM,
    else one (at D = 128 two in bf16, one in float32); the ring's stages
    (one for float32 with one consumer, else three), the block's shared
    memory (Q, the stages' K and V, their table slices and flags, the
    barriers) and the blocks an SM it is built for; and for each 64-row
    query tile (by its index) the key tiles each consumer takes, in order.
    In bf16 at D = 256 (129 to 256 padded to it) the rows form: blocks of
    128 query rows whose two consumers own a 64-row half each (query tile i
    is consumer i % 2 of block i // 2) and both take every key tile, each
    computing those its rows attend; two stages. Over D = 128 in float32,
    and over 256 in bf16, the column-sliced form: one consumer, two stages,
    `slices` blocks (one a 64-wide slice of the output) for each of the
    grid's, each visiting the same key tiles."""
    f32 = dtype == torch.float32
    slices = _slices(d, dtype)
    rows = False
    if slices > 1:  # the column-sliced form
        two, stages, smem, blocks = False, 2, _wide_smem(dtype), 2
    else:
        d = flash_head_dim(d, dtype)
        rows = d == BF16_DIM
        if d > 64:
            two = not f32
        else:
            two = m > _TILE if f32 else b * h * _tiles(n) < 2 * PLAN_SMS
        stages = 2 if rows else 1 if f32 and not two else 3
        oper = _operand_bytes(d, dtype)
        misc = _MISC_ROWS if rows else _MISC_FWD
        smem = (2 if rows else 1) * oper + stages * (2 * oper + misc) + 128
        blocks = 1 if two or (f32 and d > 64) else 2 if f32 else 3
    tiles = {}
    for i in range(_tiles(n)):
        q0 = i * _TILE
        kv_end = min(m, q0 + _TILE + m - n) if causal else m
        keys = list(range(_tiles(kv_end)))
        tiles[i] = (keys[0::2], keys[1::2]) if two and not rows else (keys, [])
    block_rows = 2 * _TILE if rows else _TILE
    return {"grid": (b * h, -(-n // block_rows)), "rows": block_rows, "slices": slices,
            "consumers": 2 if two else 1, "stages": stages, "smem": smem, "blocks": blocks,
            "tiles": tiles}


def dq_plan(b, h, hk, n, m, causal, dtype=torch.float32, dbias=False, d=64):
    """K2's launch: grid (b, h, query tiles), the last query tile first;
    each block a producer warpgroup and one consumer warpgroup that takes
    its query tile's key tiles up to the diagonal in order through a ring
    of `stages` (two in float32, three in bf16; in float32 at D = 128 one
    slot that each key tile's V and then K take in turn, `items` 2 a key
    tile); with the (H, N, M) bias's gradient (K5, `dbias`) the blocks of
    one (head, query tile) form a cluster of the largest divisor of b up to
    8, which sums their dS tiles in rank order (by atomics between clusters,
    b > 8 without such a divisor, only where b / cluster > 1), else clusters
    of one; the block's shared memory (with K5's buffers, else K4's) and the
    blocks an SM it is built for; and for each query tile (by its index) the
    key tiles, in order. In bf16 at D = 256 (129 to 256 padded to it) the
    same block with two stages, one an SM. In float32 at D = 256 (129 to 256
    padded to it) the chunked form: Q and dO resident unsplit, K and V
    streamed 64 columns at a time through two stages, `items` 12 a key tile
    (K's four chunks for S, V's four for dP, K's four again, transposed, for
    dq), one block an SM. Over 256 the column-sliced form: `slices` blocks (one a
    64-wide slice of dq; slice 0's write the bias's gradient) for each of
    the grid's, two stages, `items` 2 D / 64 + 1 a key tile (the chunks of
    S's and dP's operands, then K's slice), K5's cluster as above."""
    f32 = dtype == torch.float32
    slices = _slices(d, dtype, "K2")
    grad = _K5_BYTES if dbias else _K4_BYTES  # the bias gradient's buffers
    if slices > 1:  # the column-sliced form
        stages, items, smem, blocks = 2, 2 * slices + 1, _wide_smem(dtype) + grad, 2
    elif f32 and flash_head_dim(d, dtype, "K2") == F32_DIM:  # the chunked form
        stages, items, blocks = 2, 3 * _CHUNK_ITEMS, 1
        smem = _CHUNK_FIXED + stages * _CHUNK_STAGE + 2 * _MISC_FWD + 256 + grad
    else:
        d = flash_head_dim(d, dtype, "K2")
        seq = f32 and d > 64
        stages = 1 if seq else 2 if f32 or d > HEAD_DIMS[-1] else 3
        items = 2 if seq else 1
        oper = _operand_bytes(d, dtype)
        smem = 2 * oper + stages * ((oper if seq else 2 * oper) + _MISC_FWD) + 256 + grad
        blocks = 1 if f32 or d > 64 else 2
    cluster = max(c for c in range(1, _MAX_CLUSTER + 1) if b % c == 0) if dbias else 1
    tiles = {}
    for i in range(_tiles(n)):
        kv_end = min(m, i * _TILE + _TILE + m - n) if causal else m
        tiles[i] = list(range(_tiles(kv_end)))
    return {"grid": (b, h, _tiles(n)), "slices": slices, "cluster": cluster, "stages": stages,
            "items": items, "smem": smem, "blocks": blocks, "atomic": dbias and cluster < b,
            "tiles": tiles}


def dkv_plan(b, h, hk, n, m, dtype=torch.float32, d=64):
    """K3's launch: the cluster (the largest divisor of the MQA group up to
    8: its blocks take the kv head's query heads in turn and their sums meet
    in rank order), the number of chunks the query range is split into (only
    when fewer blocks than PLAN_SMS would run, each chunk keeping 4 query
    tiles; the chunks' partials add in chunk order in a second pass), the
    consumer warpgroups a block (two, which take the items in turn, for
    float32, and for bf16 grids under two blocks an SM; else one; at D = 128
    two in bf16, one in float32), the ring's stages (in float32 at D = 128
    one slot that an item's Q, dO and Q again take in turn, `items` 3 an
    item), the block's shared memory and the blocks an SM it is built for,
    and the grid (cluster, b*hk, key tiles * chunks). In bf16 at D = 256
    (129 to 256 padded to it) the pair form (`pair`): two consumers that
    both take every item, one holding dk and the other dv, two stages, one
    block an SM. In float32 at D = 256 (129 to 256 padded to it) the chunked
    pair form: its two consumers one a gradient as in bf16's, K and V
    resident unsplit, Q and dO streamed 64 columns at a time through two
    stages, `items` 16 an item (Q's and dO's four chunks in turns, the dk
    consumer taking Q's for S^T and the dv consumer dO's for dP^T, then both
    four again, transposed, for dK and dV), P^T and dS^T handed over as
    float32, one block an SM; under two blocks an SM its grid is split into
    query chunks of at least 2 query tiles.
    Over 256 the column-sliced form: `slices` blocks (one a 64-wide slice of
    dk and dv) for each of the grid's, no cluster and no chunks (a block
    walks every query head of its kv head), one consumer, two stages,
    `items` 2 D / 64 + 1 a (head, query tile)."""
    f32 = dtype == torch.float32
    slices = _slices(d, dtype, "K3")
    if slices > 1:
        return {"cluster": 1, "qsplit": 1, "consumers": 1, "pair": False, "stages": 2,
                "items": 2 * slices + 1, "smem": _wide_smem(dtype), "blocks": 2,
                "grid": (1, b * hk, _tiles(m)), "slices": slices}
    d = flash_head_dim(d, dtype, "K3")
    chunked = f32 and d == F32_DIM
    pair = chunked or (not f32 and d == BF16_DIM)
    seq = f32 and d > 64 and not chunked
    group = h // hk
    cluster = max(c for c in range(1, _MAX_DKV_CLUSTER + 1) if group % c == 0)
    base = cluster * b * hk * _tiles(m)
    qsplit = 1 if base >= PLAN_SMS else max(1, min(PLAN_SMS // base, _tiles(n) // 4))
    if chunked and base < 2 * PLAN_SMS:  # few, long blocks: split under two an SM
        qsplit = max(qsplit, min(-(-2 * PLAN_SMS // base), _tiles(n) // 2))
    two = (not f32 or chunked) if d > 64 else f32 or base * qsplit < 2 * PLAN_SMS
    stages = 1 if seq else 2 if f32 or pair else 4
    if chunked:  # K, V unsplit; the ring; two items' misc; flags; P^T, dS^T float32; barriers
        smem = _CHUNK_FIXED + stages * _CHUNK_STAGE + 2 * _MISC_DKV \
            + (64 + 4) * 4 + 2 * 64 * 64 * 4 + 128
    else:
        oper = _operand_bytes(d, dtype)
        smem = 2 * oper + stages * ((oper if seq else 2 * oper) + _MISC_DKV) + (64 + 4) * 4 \
            + (_PAIR_BYTES if pair else 0) + 128
    return {"cluster": cluster, "qsplit": qsplit, "consumers": 2 if two else 1, "pair": pair,
            "stages": stages, "items": 4 * _CHUNK_ITEMS if chunked else 3 if seq else 1,
            "smem": smem, "blocks": 1 if two or seq else 2,
            "grid": (cluster, b * hk, _tiles(m) * qsplit), "slices": 1}


def dkv_items(plan, h, hk, n, m, causal, kv_head, key_tile, rank, chunk):
    """The (query head, first query row) items of one K3 block, each 64 query
    rows from the diagonal on (so not aligned to 64 where M - N is not), as
    its consumer warpgroups take them, in order: ([first's], [second's], the
    second empty with one consumer, and in the pair form, whose two
    consumers take every item, one for dk and one for dv). The block's dk,
    dv is the first's sum plus the second's; the cluster adds its blocks' in
    rank order, and the chunks add in chunk order."""
    group, cluster, qsplit = h // hk, plan["cluster"], plan["qsplit"]
    k0 = key_tile * _TILE
    q_start = max(0, k0 - (m - n)) if causal else 0
    nqt = _tiles(n - q_start) if q_start < n else 0
    per = -(-nqt // qsplit)
    qa = min(nqt, chunk * per)
    nq = min(nqt, qa + per) - qa
    items = [(kv_head * group + rank + cluster * (it // nq), q_start + (qa + it % nq) * _TILE)
             for it in range(group // cluster * nq)]
    return (items[0::2], items[1::2]) if plan["consumers"] == 2 and not plan["pair"] \
        else (items, [])


def _fn(source, name, argtypes):
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _fwd_fn():
    return _fn(SOURCE, "flash_fwd", [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P, _I])


def _check(q, k, v, bias_tab, key_mask, causal, bias=None):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be (B, H, N, D), (B, Hk, M, D), (B, Hk, M, D)")
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % hk:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in {list(_DTYPES)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if bias_tab is not None and n != m:
        raise ValueError("the bias table needs N == M")
    if causal and m < n:
        raise ValueError("causal attention needs M >= N keys (aligned to the bottom right)")
    if bias_tab is not None and (bias_tab.shape != (2 * n - 1, h)
                                 or bias_tab.device != q.device):
        raise ValueError(f"bias_tab must be (2N-1, H) = {(2 * n - 1, h)} on q's device")
    if bias is not None:
        if bias_tab is not None:
            raise ValueError("pass bias or bias_tab, not both")
        if bias.shape not in ((h, n, m), (b, h, n, m)) or bias.device != q.device \
                or not bias.is_floating_point():
            raise ValueError(f"bias must be float (H, N, M) = {(h, n, m)} or (B, H, N, M) "
                             f"on q's device, not {tuple(bias.shape)}")
    if key_mask is not None and (key_mask.shape != (b, m) or key_mask.dtype != torch.bool
                                 or key_mask.device != q.device):
        raise ValueError(f"key_mask must be bool (B, M) = {(b, m)} on q's device")


def _check_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention path for device {q.device}")


def _padded(*xs, d=None):
    """xs zero-padded along their last dim to the head dim d
    (`native_head_dim`'s when not given; the tensors themselves where they
    have it)."""
    dn = native_head_dim(xs[0].shape[-1]) if d is None else d
    return [x if x.shape[-1] == dn else F.pad(x, (0, dn - x.shape[-1])) for x in xs]


def _check_layout(q, k, v):
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start 16-byte aligned: the kernels copy rows 16 bytes "
                         "at a time")


def _kernel_args(bias_tab, key_mask, bias=None):
    """The table and the bias as float32 and the key mask as int8, each
    contiguous (the bias 16-byte aligned), or None."""
    tab = bias_tab.float().contiguous() if bias_tab is not None else None
    kmask = key_mask.to(torch.int8).contiguous() if key_mask is not None else None
    dense = bias.float().contiguous() if bias is not None else None
    if dense is not None and dense.data_ptr() % 16:  # the kernels copy its rows in 16-byte chunks
        dense = dense.clone()
    return tab, kmask, dense


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _batched(bias):
    """1 for a per-batch (B, H, N, M) bias, the kernels' last argument."""
    return int(bias is not None and bias.ndim == 4)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward(q, k, v, bias_tab, bias, key_mask, causal, scale):
    """(out, lse): the kernel on a CUDA tensor, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, bias_tab=bias_tab, bias=bias, key_mask=key_mask,
                                   causal=causal, scale=scale, return_lse=True)
    _check_cuda(q)
    d = q.shape[-1]
    q, k, v = _padded(q, k, v, d=flash_head_dim(d, q.dtype))
    _check_layout(q, k, v)
    tab, kmask, dense = _kernel_args(bias_tab, key_mask, bias)
    out, lse = fwd(q, k, v, tab, kmask, causal=causal, scale=scale, bias=dense)
    return out[..., :d], lse


def fwd(q, k, v, tab, kmask, *, causal: bool, scale: float, bias=None):
    """K1 on prepared arguments (contiguous, D the kernels' own:
    `flash_head_dim(D, dtype) == D`; tab and bias float32 and kmask int8 or
    None): out in q's dtype and lse (B, H, N) float32."""
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    err = _fwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(tab), _ptr(bias),
                    _ptr(kmask), out.data_ptr(), lse.data_ptr(), b * h, h, h // hk, n, m, d,
                    scale, int(causal), _DTYPES[q.dtype], _stream(q), _batched(bias))
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Forward K1; backward K2 (dq) with the bias's gradient in the same
    launch (K4 for the table, K5 for an (H, N, M) bias) and K3 (dk, dv),
    recomputing P from the forward's logsumexp (the port's counterpart of
    the JAX package's custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, bias_tab, bias, key_mask, causal, scale):
        out, lse = _forward(q, k, v, bias_tab, bias, key_mask, causal, scale)
        ctx.save_for_backward(q, k, v, bias_tab, bias, key_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, bias_tab, bias, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_bwd(q, k, v, bias_tab, key_mask, out, lse, g,
                                                bias=bias, causal=ctx.causal, scale=ctx.scale)
        given = bias_tab if bias_tab is not None else bias
        if dbias is not None:
            dbias = dbias.to(given.dtype)
        if bias_tab is not None:
            return dq, dk, dv, dbias, None, None, None, None
        return dq, dk, dv, None, dbias, None, None, None


def flash_attention(q, k, v, *, bias_tab=None, bias=None, key_mask=None,
                    causal: bool = False, scale: "float | None" = None,
                    return_lse: bool = False):
    """q: (B, H, N, D); k, v: (B, Hk, M, D) with Hk dividing H (MQA: the kv
    head of query head h is h // (H // Hk)). bias_tab: (2N-1, H) rel-pos
    distance table, or bias: additive (H, N, M) float bias shared over the
    batch, or a (B, H, N, M) one a batch row, or neither. key_mask: (B, M) bool,
    True = attend. Causal attention with M >= N is aligned to the bottom
    right: key k is seen by query q iff k <= q + M - N (`attend`'s
    tril(M - N)), so a prefix of M - N keys is seen by every query. Returns out (B, H, N, D) in q's dtype [and lse (B, H, N)
    float32], differentiable in q, k, v and the bias."""
    _check(q, k, v, bias_tab, key_mask, causal, bias)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    out, lse = _FlashAttention.apply(q, k, v, bias_tab, bias, key_mask, bool(causal), scale)
    return (out, lse) if return_lse else out


def flash_attention_ref(q, k, v, *, bias_tab=None, bias=None, key_mask=None,
                        causal: bool = False, scale: "float | None" = None,
                        return_lse: bool = False):
    """Plain PyTorch version of the forward kernel, in float32, or in float64
    for float64 inputs (the counterpart of the JAX package's
    `_math_reference`): same arguments, same results."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    sim = _scores(q, k, bias_tab, key_mask, causal, scale, bias)
    vf = v.to(sim.dtype).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    out = torch.matmul(sim.softmax(-1), vf).to(q.dtype)
    return (out, sim.logsumexp(-1)) if return_lse else out


def _scores(q, k, bias_tab, key_mask, causal, scale, bias=None):
    """(B, H, N, M) logits, float32 (float64 for float64 q), with the bias
    added and masked entries at -1e30, as the kernels form them."""
    n, m = q.shape[2], k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(ct).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    sim = torch.matmul(q.to(ct) * scale, kf.transpose(-1, -2))
    if bias_tab is not None:
        sim = sim + toeplitz_expand(bias_tab.to(ct), n, m)
    if bias is not None:
        sim = sim + bias.to(ct)
    if key_mask is not None:
        sim = sim.masked_fill(~key_mask[:, None, None, :], _NEG_INF)
    if causal:
        keep = torch.ones(n, m, dtype=torch.bool, device=q.device).tril(m - n)
        sim = sim.masked_fill(~keep, _NEG_INF)
    return sim


def flash_attention_bwd_ref(q, k, v, bias_tab, key_mask, out, lse, g, *,
                            causal: bool, scale: float, bias=None):
    """Plain PyTorch version of the backward kernels, in float32 (float64 for
    float64 inputs): P is recomputed from the forward's `lse` (rows with
    lse <= -5e29, the fully masked ones, get p = 0), Delta = rowsum(dO * O),
    dS = P * (dP - Delta). Returns dq, dk, dv in their inputs' dtypes and the
    float32 (or float64) gradient of the bias given: dtab (2N-1, H) for a table, dbias = sum over the batch of
    dS (H, N, M) for a shared bias, dS itself (B, H, N, M) for a per-batch
    one; None without a bias."""
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    group = h // hk
    ct = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(ct).repeat_interleave(group, dim=1)
    vf = v.to(ct).repeat_interleave(group, dim=1)
    gf = g.to(ct)
    p = torch.exp(_scores(q, k, bias_tab, key_mask, causal, scale, bias) - lse[..., None])
    p = p.masked_fill(~(lse > _NEG_INF / 2)[..., None], 0.0)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * out.to(ct)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = scale * torch.matmul(ds, kf)
    # the query heads of one kv head sum into it (MQA)
    dk = (scale * torch.matmul(ds.transpose(-1, -2), q.to(ct))).view(b, hk, group, m, d).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), gf).view(b, hk, group, m, d).sum(2)
    dbias = None
    if bias_tab is not None:
        delta_idx = (torch.arange(n, device=q.device)[:, None]
                     - torch.arange(m, device=q.device)[None, :] + (m - 1))
        dbias = torch.zeros(2 * n - 1, h, dtype=ct, device=q.device)
        dbias.index_add_(0, delta_idx.reshape(-1), ds.sum(0).permute(1, 2, 0).reshape(n * m, h))
    elif bias is not None:
        dbias = ds if bias.ndim == 4 else ds.sum(0)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _bwd_launch(name, outs, q, k, v, g, lse, delta, tab, kmask, *, causal, scale, bias=None):
    """outs: K2's (dq, the bias's gradient, K4's scratch) or K3's (dk, dv),
    each a tensor or None."""
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    # q k v g lse delta tab bias kmask, the outputs, b heads hk n m d, scale, causal
    # dtype stream, per-batch bias
    fn = _fn(SOURCE_BWD, name, [_P] * (9 + len(outs)) + [_I] * 6 + [_F, _I, _I, _P, _I])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), _ptr(tab), _ptr(bias), _ptr(kmask), *(_ptr(o) for o in outs),
             b, h, hk, n, m, d, scale, int(causal), _DTYPES[q.dtype], _stream(q),
             _batched(bias))
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def bwd_dq(q, k, v, g, lse, delta, tab, kmask, *, causal: bool, scale: float, bias=None):
    """K2 on prepared arguments (contiguous, D the backward's own:
    `flash_head_dim(D, dtype, "K2") == D`; tab and bias
    float32 and kmask int8 or None; lse and delta (B, H, N) float32): dq in
    q's dtype, and in the same launch the float32 gradient of the bias given, summed over the
    batch: with a table K4, the (2N-1, H) gradient, its partial sums in K2's
    launch and added in a fixed order by a second launch (the same bits every
    run); with an (H, N, M) bias K5, its (H, N, M) gradient, summed over a
    cluster of the batch rows in a fixed order (by atomics between clusters,
    into a zeroed buffer, only for B > 8); with a (B, H, N, M) bias its
    gradient, dS, each element written once; else None."""
    dq = torch.empty_like(q)
    dgrad = part = None
    if tab is not None:
        dgrad = torch.empty_like(tab)
        b, h, n, _ = q.shape
        tiles = -(-n // 64), -(-k.shape[2] // 64)  # 64-row query and key tiles
        part = torch.empty(b * h * tiles[0] * 64 * (tiles[1] + 1), device=q.device)
    elif bias is not None:
        shared_by_atomics = bias.ndim == 3 and q.shape[0] > _MAX_CLUSTER
        dgrad = torch.zeros_like(bias) if shared_by_atomics else torch.empty_like(bias)
    _bwd_launch("flash_bwd_dq", (dq, dgrad, part), q, k, v, g, lse, delta, tab, kmask,
                causal=causal, scale=scale, bias=bias)
    global launches_dq, launches_dtab, launches_dbias, launches_dbias_per_batch
    launches_dq += 1
    if tab is not None:
        launches_dtab += 1
    elif bias is not None and bias.ndim == 4:
        launches_dbias_per_batch += 1
    elif bias is not None:
        launches_dbias += 1
    return dq, dgrad


def bwd_dkv(q, k, v, g, lse, delta, tab, kmask, *, causal: bool, scale: float, bias=None):
    """K3 on prepared arguments (as `bwd_dq`'s): dk, dv in k's dtype, the
    query heads of each kv head summed in the kernel (and, where `dkv_plan`
    splits the query range, the chunks' partials by a second launch of the
    same call)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_bwd_dkv", (dk, dv), q, k, v, g, lse, delta, tab, kmask,
                causal=causal, scale=scale, bias=bias)
    global launches_dkv
    launches_dkv += 1
    return dk, dv


def fwd_plan_built(b, h, n, m, dtype, d=64):
    """K1's block as the built library chooses it: (consumers, stages,
    shared memory, blocks an SM)."""
    out = (ctypes.c_int * 4)()
    fn = _fn(SOURCE, "flash_fwd_plan", [_I] * 5 + [_P])
    if fn(b * h, n, m, d, _DTYPES[dtype], out) != 0:
        raise ValueError(f"no K1 plan for d={d} {dtype}")
    return tuple(out)


def dq_plan_built(b, h, hk, n, m, dtype, dbias=False, d=64):
    """K2's plan as the built library computes it: (cluster, stages, shared
    memory, blocks an SM)."""
    out = (ctypes.c_int * 4)()
    fn = _fn(SOURCE_BWD, "flash_dq_plan", [_I] * 8 + [_P])
    if fn(b, h, hk, n, m, d, _DTYPES[dtype], int(dbias), out) != 0:
        raise ValueError(f"no K2 plan for b={b} h={h} hk={hk} n={n} m={m} d={d} {dtype}")
    return tuple(out)


def dkv_plan_built(b, h, hk, n, m, dtype, d=64):
    """K3's plan as the built library computes it: (cluster, query chunks,
    consumers a block, stages, shared memory, blocks an SM)."""
    out = (ctypes.c_int * 6)()
    fn = _fn(SOURCE_BWD, "flash_dkv_plan", [_I] * 7 + [_P])
    if fn(b, h, hk, n, m, d, _DTYPES[dtype], out) != 0:
        raise ValueError(f"no K3 plan for b={b} h={h} hk={hk} n={n} m={m} d={d} {dtype}")
    return tuple(out)


def flash_attention_bwd(q, k, v, bias_tab, key_mask, out, lse, g, *, causal: bool,
                        scale: float, bias=None):
    """dq, dk, dv and the bias's gradient (dtab with a table, dbias with an
    (H, N, M) or a (B, H, N, M) bias, else None): two launches on a CUDA
    tensor, K2 with K4 or K5 (or the per-batch bias's dS) and K3;
    `flash_attention_bwd_ref` on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, bias_tab, key_mask, out, lse, g,
                                       causal=causal, scale=scale, bias=bias)
    _check_cuda(q)
    d = q.shape[-1]
    # padded to the backward's head dim (float32's 129-255 to 256, where K1
    # keeps the column-sliced form): out's and dO's extra columns are zeros,
    # so Delta is unchanged
    q, k, v, g, out = _padded(q, k, v, g.to(q.dtype), out, d=flash_head_dim(d, q.dtype, "K2"))
    _check_layout(q, k, v)
    g = g.contiguous()
    if g.data_ptr() % 16:  # a view into a larger buffer: K3 copies its rows 16 bytes at a time
        g = g.clone()
    # Delta = rowsum(dO * O) is a torch reduction, as the JAX package leaves it to XLA
    delta = (g.float() * out.float()).sum(-1)
    tab, kmask, dense = _kernel_args(bias_tab, key_mask, bias)
    args = (q, k, v, g, lse, delta, tab, kmask)
    kw = dict(causal=causal, scale=scale, bias=dense)
    dq, dgrad = bwd_dq(*args, **kw)
    dk, dv = bwd_dkv(*args, **kw)
    return dq[..., :d], dk[..., :d], dv[..., :d], dgrad
