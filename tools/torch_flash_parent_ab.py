"""Times the flash kernels K1 (forward), K2 (dq: alone, and with K4, the
table's gradient, K5, the (H, N, M) bias's, or a per-batch (B, H, N, M)
bias's dS, in its launch) and K3 (dk, dv) at the shapes `chip_smoke.py`
holds them at, the nearest-code search K6 at the row counts the port's
paths give it, and the local attention K7 at the codec's shapes and at
every window `chip_smoke.py` holds it at: each call by CUDA events (through
its Python wrapper) and on the device (the kernel's own time from
torch.profiler), beside SDPA's device time for the same forward and for its
backward (its forward and backward less its forward; K7's on pre-built
window blocks), and for K6 beside addmm + argmin with |e|^2 summed in the
call and given. K7 at windows 64 and 128 (its aligned block) is also timed
with an (H, w, 2w) bias and beside its any-window block forced at those
windows (csrc/local_attn.cu built with -DLOCAL_ATTN_ANY_WINDOW_BLOCK), in
turns: this build, the forced one, the forced one, this. With --parent DIR it also times another checkout's kernels
(the parent commit's `audiolm_pytorch_tpu_torch/csrc/flash_fwd.cu`,
`flash_bwd.cu`, `vq.cu` and `local_attn.cu` with their headers), in one
process, in turns: the parent's build, this one's, this one's again and
the parent's again, at every flash shape (the parent's kernels take every
head dim since its column-sliced form; a head dim up to 256 that this
checkout's kernels take padded to 256, their Hopper forms, reaches the
parent's as that library takes it: D itself where it has a plan for D) and at K7's windows 64 and 128. The builds share the C
interfaces (the flash kernels' per-batch flag comes last, which an older
library ignores), so the parent's libraries are loaded in place of this
one's behind the same wrappers.

    git archive <parent> audiolm_pytorch_tpu_torch | tar -x -C build/parent
    python tools/torch_flash_parent_ab.py [--parent build/parent] [--seed N] [--json]

`chip_smoke.py` runs it in a process of its own (its `flash device times`
phase; `--parent` passed on). With --json the last line is one JSON object
of every number printed. Needs a CUDA card; imports torch, numpy, the
standard library, the port and tools/cuda_timing.py.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from audiolm_pytorch_tpu_torch.ops.kernels import _build  # noqa: E402
from audiolm_pytorch_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from audiolm_pytorch_tpu_torch.ops.kernels import local_attention as la  # noqa: E402
from audiolm_pytorch_tpu_torch.ops.kernels import vq  # noqa: E402
from tools import cuda_timing  # noqa: E402

cuda_ms = functools.partial(cuda_timing.cuda_ms, iters=20, warmup=3)
# (label, b, h, n, m, form, causal, keys, forward only, head dim):
# chip_smoke.py's shapes, each in float32 and bf16 (the stage trainers' in
# bf16 only), MQA k and v (one head); keys: "forget" drops 15% of each row's
# keys (the first kept), "ragged" masks keys >= 700 of row 1, "text" keeps
# each row's text tokens (7, 13, 9, 16 of the first P) and forgets 15% of
# the rest, "null" keeps the null key and each row's text tokens. The head
# dims over 128: the flagship's and the Coarse LM's 256, the Fine LM's 320,
# and 192 at the flagship's shape (in bf16 K1, K2 and K3 there take their
# Hopper forms at 256, in float32 K2 and K3 their chunked forms at 256, the
# rest the column-sliced form).
SHAPES = (("4x8x2048 table", 4, 8, 2048, 2048, "table", True, "forget", False),
          ("4x8x2049 table (training)", 4, 8, 2049, 2049, "table", True, "forget", False),
          ("2x8x1000 table, ragged", 2, 8, 1000, 1000, "table", True, "ragged", False),
          ("4x8x603 bias (Coarse training)", 4, 8, 603, 603, "bias", True, "forget", False),
          ("4x8x1201 bias (Fine training)", 4, 8, 1201, 1201, "bias", True, "forget", False),
          ("2x8x1000 bias, ragged", 2, 8, 1000, 1000, "bias", True, "ragged", False),
          ("4x4x150 table (Semantic trainer)", 4, 4, 150, 150, "table", True, "forget", False),
          ("4x4x602 bias (Coarse trainer)", 4, 4, 602, 602, "bias", True, "forget", False),
          ("4x4x1201 bias (Fine trainer)", 4, 4, 1201, 1201, "bias", True, "forget", False),
          ("4x8x2049 over 16 + 2049, prefix", 4, 8, 2049, 2065, "bias", True, "text", False),
          ("4x8x603 over 40 + 603, prefix", 4, 8, 603, 643, "bias", True, "text", False),
          ("4x8x2049 over 17, cross", 4, 8, 2049, 17, "none", False, "null", False),
          ("4x8x1 over 17, cross decode", 4, 8, 1, 17, "none", False, "null", True),
          ("2x4x2049 table (tensor-parallel rank)", 2, 4, 2049, 2049, "table", True, "forget",
           False),
          ("4x8x2049x128 table (flagship training, 128-wide heads)", 4, 8, 2049, 2049, "table",
           True, "forget", False, 128),
          ("4x8x2049x32 table", 4, 8, 2049, 2049, "table", True, "forget", False, 32),
          ("4x4x603x128 bias (Coarse training, 4 heads of 128)", 4, 4, 603, 603, "bias", True,
           "forget", False, 128),
          ("4x16x1201x32 bias (Fine training, 16 heads of 32)", 4, 16, 1201, 1201, "bias", True,
           "forget", False, 32),
          ("4x8x1201 per-batch bias", 4, 8, 1201, 1201, "batch_bias", True, "forget", False),
          ("4x4x603x128 per-batch bias", 4, 4, 603, 603, "batch_bias", True, "forget", False,
           128),
          ("4x4x2049x256 table (flagship training, 4 heads of 256)", 4, 4, 2049, 2049, "table",
           True, "forget", False, 256),
          ("4x2x603x256 bias (Coarse training, 2 heads of 256)", 4, 2, 603, 603, "bias", True,
           "forget", False, 256),
          ("4x2x1201x320 bias (Fine training, 2 heads of 320)", 4, 2, 1201, 1201, "bias", True,
           "forget", False, 320),
          ("4x4x2049x192 table (4 heads of 192)", 4, 4, 2049, 2049, "table", True, "forget",
           False, 192))
STAGE_ONLY_BF16 = ("trainer)",)
TEXT_LENGTHS = (7, 13, 9, 16)
# K6: (rows, codes, dim): a decode step's and a short prompt's rows, a
# streaming encoder chunk (192), codec training (400), the LM trainers'
# tokenisation (600), the codec's round trip (800), 1300, and EnCodec's
# 1200 rows of 128
VQ_SHAPES = ((1, 1024, 512), (7, 1024, 512), (192, 1024, 512), (400, 1024, 512),
             (600, 1024, 512), (800, 1024, 512), (1300, 1024, 512), (1200, 1024, 128))
# csrc/local_attn.cu's timing variant: the any-window block at every window
ANY_WINDOW_BLOCK = ("LOCAL_ATTN_ANY_WINDOW_BLOCK",)
# K7: (label, b, h, t, d, window, LocalMHA's strided views or contiguous):
# the codec's 2 s and 10 s and the streaming decoder's 208-frame window
# (timed against a parent's K7 too), every window chip_smoke.py holds it at
# on 10 s of the codec's heads (T = 500, a multiple of none of them), and
# the demo codec's (examples/train_audiolm_demo.py: 4 heads of 16, window
# 32, 200 frames a second) 8 x 2 s and training batch
LOCAL_SHAPES = (("8x8x100x64 w128 (codec 2 s)", 8, 8, 100, 64, 128, False),
                ("8x8x500x64 w128 (codec 10 s)", 8, 8, 500, 64, 128, False),
                ("1x8x208x64 w64, strided (streaming decoder window)", 1, 8, 208, 64, 64, True),
                *((f"8x8x500x64 w{w}, strided", 8, 8, 500, 64, w, True)
                  for w in (8, 16, 32, 48, 96, 256)),
                ("8x4x400x16 w32, strided (demo codec, 8 x 2 s)", 8, 4, 400, 16, 32, True),
                ("2x4x128x16 w32, strided (demo codec training)", 2, 4, 128, 16, 32, True),
                ("8x8x100x256 w128, strided (codec 2 s, attn_dim_head 256)", 8, 8, 100, 256, 128,
                 True))


def parent_library(parent: Path, name: str) -> ctypes.CDLL:
    """The parent checkout's csrc/`name`, built with its own headers into
    build/kernels/ (named by the digest of its sources and flags)."""
    csrc = parent / "audiolm_pytorch_tpu_torch" / "csrc"
    src = csrc / name
    so = _build.BUILD_DIR / f"parent-{src.stem}-{_build.source_digest(src, _build.NVCC_FLAGS, csrc)}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                               str(so), str(src)], capture_output=True, text=True,
                              timeout=_build.NVCC_TIMEOUT_S, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{proc.stderr[-4000:]}")
    return ctypes.CDLL(str(so))


@contextlib.contextmanager
def parent_kernels(parent: Path):
    """Within the block the flash and nearest-code wrappers launch the
    parent's K1-K6."""
    libs = {name: parent_library(parent, name)
            for name in (fa.SOURCE, fa.SOURCE_BWD, vq.SOURCE, la.SOURCE)}
    saved = fa.load, vq.load, la.load
    fa.load = lambda name, defines=None: libs[name] if name in libs else saved[0](name, defines)
    vq.load = lambda name, defines=None: libs[name] if name in libs else saved[1](name, defines)
    la.load = lambda name, defines=None: libs[name] if name in libs else saved[2](name, defines)
    try:
        yield
    finally:
        fa.load, vq.load, la.load = saved


def inputs(rng, dtype, b, h, n, m, form, keys, d=64):
    dev = torch.device("cuda")

    def normal(*shape, s=1.0):
        return torch.from_numpy(s * rng.standard_normal(shape, dtype=np.float32)).to(dev)

    q, k, v, g = normal(b, h, n, d), normal(b, 1, m, d), normal(b, 1, m, d), normal(b, h, n, d)
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    tab = normal(2 * n - 1, h, s=0.5) if form == "table" else None
    bias = normal(h, n, m, s=0.5) if form == "bias" else \
        normal(b, h, n, m, s=0.5) if form == "batch_bias" else None
    mask = torch.from_numpy(rng.random((b, m)) > 0.15).to(dev)
    mask[:, 0] = True
    if keys == "ragged":
        mask[:] = True
        mask[1:, 700:] = False
    elif keys in ("text", "null"):
        p = m - n if keys == "text" else m - 1
        for i in range(b):
            mask[i, :p] = False
            mask[i, :TEXT_LENGTHS[i % len(TEXT_LENGTHS)]] = True
        if keys == "null":
            mask[:, 0] = True
    return q, k, v, g, tab, bias, mask


def times(q, k, v, g, tab, bias, mask, causal, fwd_only, parent=False):
    """{K1, K2, K2 with its bias gradient (K4, K5 or a per-batch bias's dS),
    K3: (event ms, device ms, device launches per call)} of the wrappers as
    they stand, K2's and K3's prepared arguments padded to the backward's
    `fa.flash_head_dim` (outside the timed calls). With `parent` (a parent's
    libraries loaded behind the wrappers) K1 and K2, K3 take the head dim
    that library has a plan for: D itself where it has one, else
    `fa.flash_head_dim`'s (a library that refuses D unpadded), padded outside
    the timed calls, so a parent's kernels run as they ran there."""
    b, h, n, d = q.shape
    hk, m = k.shape[1], k.shape[2]
    scale = d ** -0.5
    kw = dict(causal=causal, scale=scale)

    def head_dim(plan_built, kernel):
        if parent:
            try:
                plan_built(d)
                return d
            except ValueError:
                pass
        return fa.flash_head_dim(d, q.dtype, kernel)

    tabc, kmask, dense = fa._kernel_args(tab, mask, bias)
    fwd_args = fa._padded(q, k, v, d=head_dim(
        lambda x: fa.fwd_plan_built(b, h, n, m, q.dtype, x), "K1"))
    with torch.no_grad():
        out, lse = fa.fwd(*fwd_args, tabc, kmask, bias=dense, **kw)
    out = out[..., :d]
    prepared = fa._padded(q, k, v, g, d=head_dim(
        lambda x: fa.dq_plan_built(b, h, hk, n, m, q.dtype, d=x), "K2"))
    args = (*prepared, lse, (g.float() * out.float()).sum(-1), tabc, kmask)
    dq_out = torch.empty_like(prepared[0])

    def k1():
        if parent:
            return fa.fwd(*fwd_args, tabc, kmask, bias=dense, **kw)
        return fa._forward(q, k, v, tab, bias, mask, causal, scale)

    def k2():  # the bias read, its gradient not asked for: K2 alone
        return fa._bwd_launch("flash_bwd_dq", (dq_out, None, None), *args, bias=dense, **kw)

    def k2_grad():  # K2 with K4 (its second pass included) or K5
        return fa.bwd_dq(*args, bias=dense, **kw)

    def k3():
        return fa.bwd_dkv(*args, bias=dense, **kw)

    # each kernel's native and column-sliced (`_wide_`) instantiations, K3's
    # pair form (bf16 at D = 256) and K2's and K3's chunked forms (float32 at
    # D = 256)
    got = {"K1": (cuda_ms(k1), *cuda_timing.named_device_ms(
        k1, ["flash_fwd_kernel", "flash_fwd_wide_kernel"]))}
    if not fwd_only:
        got["K2"] = (cuda_ms(k2), *cuda_timing.named_device_ms(
            k2, ["flash_bwd_dq_kernel", "flash_bwd_dq_wide_kernel", "flash_bwd_dq_chunk_kernel"]))
        if tab is not None or bias is not None:
            grad = "K2+K4" if tab is not None else "K2+K5" if bias.ndim == 3 else "K2+dS"
            got[grad] = (cuda_ms(k2_grad), *cuda_timing.named_device_ms(
                k2_grad, ["flash_bwd_dq_kernel", "flash_bwd_dq_wide_kernel",
                          "flash_bwd_dq_chunk_kernel", "dtab_sum_kernel"]))
        got["K3"] = (cuda_ms(k3), *cuda_timing.named_device_ms(
            k3, ["flash_bwd_dkv_kernel", "flash_bwd_dkv_pair_kernel", "flash_bwd_dkv_wide_kernel",
                 "flash_bwd_dkv_chunk_kernel", "dkv_sum_kernel"]))
    return got


def sdpa_times(q, k, v, g, tab, bias, mask, causal, fwd_only):
    """SDPA on the same function (k, v repeated over the heads, the bias or
    the expanded table and the masks as one float mask): forward event and
    device ms, and the backward's device ms (forward and backward less
    forward; None for a forward-only shape)."""
    from audiolm_pytorch_tpu_torch.ops.relpos import toeplitz_expand
    b, h, n, _ = q.shape
    m = k.shape[2]
    base = toeplitz_expand(tab, n, n) if tab is not None else bias if bias is not None \
        else torch.zeros(1, n, m, device=q.device)
    keep = torch.ones(n, m, dtype=torch.bool, device=q.device)
    keep = (keep.tril(m - n) if causal else keep)[None, None] & mask[:, None, None, :]
    fmask = torch.where(keep, (base if base.ndim == 4 else base[None]).to(q.dtype),
                        torch.tensor(float("-inf"), dtype=q.dtype, device=q.device))
    padded = torch.empty(*fmask.shape[:-1], -(-m // 16) * 16, dtype=q.dtype, device=q.device)
    padded[..., :m] = fmask
    fmask = padded[..., :m]
    ke, ve = (x.expand(-1, h, -1, -1).contiguous() for x in (k, v))

    def call():  # inputs without gradients: the kernel inference takes
        return torch.nn.functional.scaled_dot_product_attention(q, ke, ve, attn_mask=fmask)

    fwd_ms, fwd_dev = cuda_ms(call), cuda_timing.device_per_call(call)[0]
    bwd_dev = None
    if not fwd_only:
        fm = fmask.detach().requires_grad_(bias is not None)
        qs, ks, vs = (a.detach().requires_grad_() for a in (q, ke, ve))
        wrt = (qs, ks, vs, fm) if bias is not None else (qs, ks, vs)

        def train():
            return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=fm)

        with torch.no_grad():
            train_fwd = cuda_timing.device_per_call(train)[0]
        bwd_dev = cuda_timing.device_per_call(lambda: torch.autograd.grad(train(), wrt, g))[0] \
            - train_fwd
    return fwd_ms, fwd_dev, bwd_dev


def fmt(ms):
    return "-" if ms is None else f"{ms:.4f}"


def as_row(runs):
    """{which: {"ms": [...], "device_ms": [...], "device_launches": [...]}}
    of runs {which: [(event ms, device ms, device launches per call), ...]}."""
    return {which: {"ms": [r[0] for r in got], "device_ms": [r[1] for r in got],
                    "device_launches": [r[2] for r in got]} for which, got in runs.items()}


def turns(runs):
    """The runs as "this ev/dev ev/dev | parent ev/dev ..."."""
    return " | ".join(f"{which} " + " ".join(f"{fmt(r[0])}/{fmt(r[1])}" for r in got)
                      for which, got in runs.items())


def vq_inputs(rng, n, c, d):
    """x (n, d) near random codes of a (c, d) codebook (30% of the rows far
    from any), on the card."""
    cb = rng.standard_normal((c, d), dtype=np.float32)
    x = cb[rng.integers(0, c, n)] + 0.3 * rng.standard_normal((n, d), dtype=np.float32)
    far = rng.random(n) < 0.3
    x[far] = rng.standard_normal((int(far.sum()), d), dtype=np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(cb).cuda()


def vq_times(x, cb):
    """K6's (event ms, device ms, device launches per call) through its
    wrapper as it stands."""
    def k6():
        return vq.vq_nearest_code(x, cb)
    return cuda_ms(k6), *cuda_timing.named_device_ms(k6, ["vq_nearest_kernel"])


def compare_vq(parent=None, seed=0, shapes=VQ_SHAPES):
    """Prints, per shape, K6's event and device ms (with a parent checkout:
    parent, this, this, parent) and addmm + argmin's device ms, |e|^2 summed
    in the call and given; returns {label: {...}}."""
    rows = {}
    for n, c, d in shapes:
        x, cb = vq_inputs(np.random.default_rng(seed), n, c, d)
        e2 = cb.square().sum(-1)
        runs = {"this": []}
        if parent is not None:
            runs["parent"] = []
            for which in ("parent", "this", "this", "parent"):
                with parent_kernels(parent) if which == "parent" else contextlib.nullcontext():
                    runs[which].append(vq_times(x, cb))
        else:
            runs["this"].append(vq_times(x, cb))
        summed = cuda_timing.device_per_call(
            lambda: torch.argmin(torch.addmm(cb.square().sum(-1), x, cb.t(), alpha=-2), -1))[0]
        given = cuda_timing.device_per_call(
            lambda: torch.argmin(torch.addmm(e2, x, cb.t(), alpha=-2), -1))[0]
        at = f"vq {n}x{d} vs {c}x{d}"
        rows[at] = as_row(runs)
        rows[at].update(library_device_ms=summed, library_e2_given_device_ms=given)
        print(f"device K6 [{at}]: {turns(runs)} ms (events/device) | addmm+argmin device "
              f"{fmt(summed)}, |e|^2 given {fmt(given)}", flush=True)
    return rows


def compare(parent=None, seed=0, shapes=SHAPES):
    """Prints, per shape and dtype, K1's, K2's (alone and with its bias
    gradient) and K3's event and device ms (with a parent checkout: the
    parent's build and this one's, parent, this, this, parent) and SDPA's;
    returns {label: {...}}."""
    rows = {}
    for label, b, h, n, m, form, causal, keys, fwd_only, *dim in shapes:
        d = dim[0] if dim else 64
        dtypes = ((torch.bfloat16,) if any(x in label for x in STAGE_ONLY_BF16)
                  else (torch.float32, torch.bfloat16))
        for dtype in dtypes:
            tensors = inputs(np.random.default_rng(seed), dtype, b, h, n, m, form, keys, d)
            runs = {"this": []}
            if parent is not None:
                runs["parent"] = []
                for which in ("parent", "this", "this", "parent"):
                    with parent_kernels(parent) if which == "parent" else contextlib.nullcontext():
                        runs[which].append(times(*tensors, causal, fwd_only,
                                                 parent=which == "parent"))
            else:
                runs["this"].append(times(*tensors, causal, fwd_only))
            sdpa_ms, sdpa_dev, sdpa_bwd_dev = sdpa_times(*tensors, causal, fwd_only)
            at = f"{str(dtype)[6:]} {label}"
            row = {"sdpa_ms": sdpa_ms, "sdpa_device_ms": sdpa_dev,
                   "sdpa_bwd_device_ms": sdpa_bwd_dev}
            for kernel in ("K1", "K2", "K2+K4", "K2+K5", "K2+dS", "K3"):
                if kernel not in runs["this"][0]:
                    continue
                got = {w: [r[kernel] for r in runs[w]] for w in runs}
                row[kernel] = as_row(got)
                line = f"flash device {kernel} [{at}]: {turns(got)} ms (events/device) | sdpa " + (
                    f"{fmt(sdpa_ms)}/{fmt(sdpa_dev)}" if kernel == "K1"
                    else f"backward device {fmt(sdpa_bwd_dev)}")
                print(line, flush=True)
            rows[at] = row
    return rows


def sdpa_blocks(q, k, v, w, mask, bias):
    """(B*H*nw, 1, w, D) query blocks, (B*H*nw, 1, 2w, D) key and value
    blocks (the window before and the window) and the float mask with the
    band, the first window's look-back, the key mask and the bias, for one
    SDPA call that computes K7's function. Yardstick only."""
    b, h, t, d = q.shape
    dev = q.device
    pad = (-t) % w
    nw = (t + pad) // w
    qp, kp, vp = (torch.nn.functional.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
    kw, vw = (a.reshape(b, h, nw, w, d) for a in (kp, vp))
    k2, v2 = (torch.cat([torch.nn.functional.pad(a, (0, 0, 0, 0, 1, 0))[:, :, :-1], a], 3)
              for a in (kw, vw))
    valid = torch.ones(b, t, dtype=torch.bool, device=dev) if mask is None else mask
    mw = torch.nn.functional.pad(valid, (0, pad), value=False).reshape(b, nw, w)
    key_valid = torch.cat([torch.nn.functional.pad(mw, (0, 0, 1, 0), value=False)[:, :-1], mw], 2)
    qpos = torch.arange(w, device=dev)[:, None]
    kpos = torch.arange(2 * w, device=dev)[None, :]
    allowed = (kpos <= qpos + w)[None, None, None] & key_valid[:, None, :, None, :]
    fmask = torch.zeros(b, h, nw, w, 2 * w, device=dev)
    if bias is not None:
        fmask = fmask + bias[None, :, None]
    fmask = fmask.masked_fill(~allowed, -1e9).to(q.dtype)
    return (qp.reshape(b * h * nw, 1, w, d), k2.reshape(b * h * nw, 1, 2 * w, d),
            v2.reshape(b * h * nw, 1, 2 * w, d), fmask.reshape(b * h * nw, 1, w, 2 * w))


def local_inputs(rng, dtype, b, h, t, d, strided):
    """q, k, v (b, h, t, d) on the card: LocalMHA's transposed views of one
    (b, t, 3 h d) projection, or contiguous tensors."""
    dev = torch.device("cuda")
    if strided:
        qkv = torch.from_numpy(rng.standard_normal((b, t, 3 * h * d), dtype=np.float32))
        return [a.reshape(b, t, h, d).transpose(1, 2) for a in qkv.to(dev, dtype).chunk(3, -1)]
    return [torch.from_numpy(rng.standard_normal((b, h, t, d), dtype=np.float32)).to(dev, dtype)
            for _ in range(3)]


def compare_local(parent=None, seed=0, shapes=LOCAL_SHAPES):
    """Prints, per shape and dtype, K7's event and device ms and SDPA's on
    pre-built blocks (events and device); returns {label: {...}}. Where the
    aligned block runs (w a multiple of 64, head dim 64), also with an (H,
    w, 2w) bias, and beside the any-window block forced at every window
    (this checkout built with ANY_WINDOW_BLOCK, its output held to this
    build's) and, at windows 64 and 128 (all a parent's K7 takes), a parent
    checkout's, in turns: parent, this, general, general, this, parent."""
    rows = {}
    for label, b, h, t, d, w, strided in shapes:
        aligned = w % 64 == 0 and d == 64
        order = ("this",)
        if aligned:
            order = ("this", "general", "general", "this")
            if parent is not None and w in (64, 128):
                order = ("parent", *order, "parent")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = local_inputs(np.random.default_rng(seed), dtype, b, h, t, d, strided)
            scale = 8.0 / d
            bias = torch.from_numpy(0.3 * np.random.default_rng(seed + 1).standard_normal(
                (h, w, 2 * w), dtype=np.float32)).cuda()
            for form, attn_bias in (("", None), (", bias", bias))[:2 if aligned else 1]:
                def k7():
                    return la.local_attention(q, k, v, window_size=w, scale=scale,
                                              attn_bias=attn_bias)

                runs = {which: [] for which in ("this", *order)}
                for which in order:
                    with (parent_kernels(parent) if which == "parent"
                          else _build.built_with(ANY_WINDOW_BLOCK) if which == "general"
                          else contextlib.nullcontext()):
                        runs[which].append((cuda_ms(k7), *cuda_timing.named_device_ms(
                            k7, ["local_attn_kernel", "local_attn_wide_kernel"])))
                at = f"{str(dtype)[6:]} {label}{form}"
                if aligned:
                    with _build.built_with(ANY_WINDOW_BLOCK):
                        general = k7()
                    tol = 2e-3 if dtype == torch.float32 else 3e-2
                    if not torch.allclose(general.float(), k7().float(), rtol=tol, atol=tol):
                        raise AssertionError(f"K7's any-window block differs from the aligned "
                                             f"block [{at}]")
                qb, kb, vb, fmask = sdpa_blocks(q, k, v, w, None, attn_bias)

                def library():
                    return torch.nn.functional.scaled_dot_product_attention(
                        qb, kb, vb, attn_mask=fmask, scale=scale)

                sdpa_ms, sdpa_dev = cuda_ms(library), cuda_timing.device_per_call(library)[0]
                rows[at] = as_row(runs)
                rows[at].update(sdpa_ms=sdpa_ms, sdpa_device_ms=sdpa_dev)
                print(f"device K7 [{at}]: {turns(runs)} ms (events/device) | sdpa on blocks "
                      f"{fmt(sdpa_ms)}/{fmt(sdpa_dev)}", flush=True)
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", action="store_true", help="end with a JSON line of the numbers")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    rows = compare(args.parent, args.seed)
    rows.update(compare_vq(args.parent, args.seed))
    rows.update(compare_local(args.parent, args.seed))
    if args.json:
        print(json.dumps(rows))


if __name__ == "__main__":
    main()
