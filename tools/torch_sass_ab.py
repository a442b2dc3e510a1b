"""Compares the tensor-core instruction counts (HMMA, HGMMA, UTMALDG, FFMA,
as `_build.sass_counts` counts them) of every kernel in this checkout's
CUDA libraries with another checkout's (such as the parent commit's,
unpacked by git archive), kernel by kernel, by `chip_smoke.py`'s labels
(flash_bwd_dq_kernel<bf16, d64, sum>): a header edit that should change no
kernel (a helper removed) shows as no difference. Prints one line a kernel
that differs or exists in only one build, and a summary; exits 1 where a
kernel of both builds differs.

    git archive <parent> audiolm_pytorch_tpu_torch | tar -x -C build/parent
    python tools/torch_sass_ab.py --parent build/parent

Needs nvcc and cuobjdump (the CUDA toolkit); no card.
"""
from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from audiolm_pytorch_tpu_torch.ops.kernels import _build  # noqa: E402
from tools.torch_flash_parent_ab import parent_library  # noqa: E402


def counts(so: Path) -> "dict[str, dict[str, int]]":
    """{label: {opcode: n}} of the kernels in the library at `so`."""
    return {chip_smoke.kernel_label(mangled): ops
            for mangled, ops in _build.sass_counts_of(so).items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True)
    args = parser.parse_args()
    sources = chip_smoke.SOURCES
    with ThreadPoolExecutor(2 * len(sources)) as pool:
        mine = [pool.submit(_build.load, src) for src in sources]
        theirs = [pool.submit(parent_library, args.parent, src) for src in sources]
        libs = [(src, _build.library_path(src), Path(t.result()._name))
                for src, _, t in zip(sources, [m.result() for m in mine], theirs)]
    differ = same = 0
    for src, so, parent_so in libs:
        got, want = counts(so), counts(parent_so)
        for label in sorted(set(got) | set(want)):
            if label not in want or label not in got:
                print(f"{src} {label}: only in {'this' if label in got else 'the parent'}'s "
                      f"build {got.get(label, want.get(label))}")
            elif got[label] != want[label]:
                differ += 1
                print(f"{src} {label}: this {got[label]}, the parent {want[label]}")
            else:
                same += 1
    print(f"sass: {same} kernels of both builds with the same counts, {differ} differing")
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
