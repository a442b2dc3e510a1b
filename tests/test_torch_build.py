"""The kernels' build rule (`ops/kernels/_build.py`), on the CPU and without
nvcc: a library's name carries a digest of its source, of every header in
`csrc/` and of the flags, so an edit to a shared header rebuilds every
source that may include it."""
import re
import subprocess
from pathlib import Path

import pytest

from audiolm_pytorch_tpu_torch.ops.kernels import _build

SOURCES = ["flash_fwd.cu", "flash_bwd.cu", "vq.cu", "local_attn.cu"]


@pytest.fixture
def csrc(tmp_path):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\nextern "C" int f() { return 0; }\n')
    (tmp_path / "shared.cuh").write_text("#pragma once\nconstexpr int X = 1;\n")
    return tmp_path


def _digest(csrc, flags=("-O3",)):
    return _build.source_digest(csrc / "k.cu", list(flags), csrc)


def test_digest_is_stable(csrc):
    assert _digest(csrc) == _digest(csrc)
    assert re.fullmatch(r"[0-9a-f]{16}", _digest(csrc))


@pytest.mark.parametrize("edit", ["header bytes", "new header", "renamed header", "source",
                                  "flags"])
def test_digest_changes_with_what_the_build_reads(csrc, edit):
    before = _digest(csrc)
    flags = ("-O3",)
    if edit == "header bytes":
        (csrc / "shared.cuh").write_text("#pragma once\nconstexpr int X = 2;\n")
    elif edit == "new header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    elif edit == "renamed header":
        (csrc / "shared.cuh").rename(csrc / "shared2.cuh")
    elif edit == "source":
        (csrc / "k.cu").write_text('#include "shared.cuh"\nextern "C" int f() { return 1; }\n')
    else:
        flags = ("-O3", "-DMMA_TF32_ONE_PASS")
    assert _digest(csrc, flags) != before


def test_digest_ignores_files_the_build_does_not_read(csrc):
    before = _digest(csrc)
    (csrc / "notes.txt").write_text("not a header")
    (csrc / "other.cu").write_text("// another source, not included")
    assert _digest(csrc) == before


@pytest.mark.parametrize("name", SOURCES)
def test_every_included_header_is_in_the_digest(name):
    src = (_build.CSRC / name).read_text()
    for header in re.findall(r'#include "([^"]+)"', src):
        assert header.endswith(".cuh") and (_build.CSRC / header).exists(), header


@pytest.mark.parametrize("name", SOURCES)
def test_library_path_names_source_variant_and_digest(name):
    plain = _build.library_path(name)
    variant = _build.library_path(name, ("MMA_TF32_ONE_PASS",))
    assert plain.parent == variant.parent == _build.BUILD_DIR
    assert plain.name.startswith(Path(name).stem + "-") and plain.suffix == ".so"
    assert "-MMA_TF32_ONE_PASS-" in variant.name
    assert plain != variant and plain == _build.library_path(name)


def test_load_passes_the_header_directory_and_defines_to_nvcc(monkeypatch, tmp_path):
    seen = {}

    def fake_run(cmd, **kw):
        seen["cmd"] = cmd
        return subprocess.CompletedProcess(cmd, 1, stdout="", stderr="fake nvcc refused")

    monkeypatch.setattr(_build, "_tool", lambda name: name)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="fake nvcc refused"):
        _build.load("flash_fwd.cu", ("MMA_TF32_ONE_PASS",))
    cmd = seen["cmd"]
    assert cmd[cmd.index("-I") + 1] == str(_build.CSRC)
    assert "-DMMA_TF32_ONE_PASS" in cmd and "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == str(_build.CSRC / "flash_fwd.cu")


SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvPKT_S3_S3_PKfS5_PKaPS1_Pfiiiifi
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0b50*/                   HMMA.1688.F32.TF32 R20, R4, R24, R20 ;
        /*0b60*/              @!P0 FFMA R2, R3, R4, R5 ;
        /*0b70*/                   HMMA.1688.F32.TF32 R28, R4, R26, R28 ;
		Function : _ZN12_GLOBAL__N_120flash_bwd_dq_kernelI13__nv_bfloat16Li64EEEvPKT_
        /*0000*/                   FFMA R2, R3, R4, R5 ;
        /*0010*/                   FMUL R2, R3, R4 ;
"""


def test_sass_counts_reads_opcodes_per_kernel(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: None)
    monkeypatch.setattr(_build, "_tool", lambda name: name)
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 0, stdout=SASS))
    counts = _build.sass_counts("flash_fwd.cu")
    fwd, dq = sorted(counts, key=lambda name: "dq" in name)
    assert "flash_fwd_kernel" in fwd and "flash_bwd_dq_kernel" in dq
    assert counts[fwd] == {"HMMA": 2, "HGMMA": 0, "UTMALDG": 0, "FFMA": 1}
    assert counts[dq] == {"HMMA": 0, "HGMMA": 0, "UTMALDG": 0, "FFMA": 1}


# a warp-specialised kernel's SASS: TMA tile loads (one predicated on a
# uniform predicate), warpgroup products and a warp's product
SASS_WGMMA = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116flash_fwd_kernelI13__nv_bfloat16EEv14CUtensorMap_stS2_S2_PKfS4_PKaPT_Pfiiiifi
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0400*/                   UTMALDG.3D [UR8], [UR4], desc[UR6] ;
        /*0410*/             @!UP0 UTMALDG.3D [UR16], [UR12], desc[UR6] ;
        /*0a80*/                   WARPGROUP.ARRIVE ;
        /*0a90*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT ;
        /*0aa0*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24 ;
        /*0ab0*/                   HGMMA.64x64x16.F32.BF16 R24, R88, gdesc[UR16], R24, gsb0 ;
        /*0b50*/                   HMMA.1688.F32.TF32 R20, R4, R24, R20 ;
        /*0b60*/                   FFMA R2, R3, R4, R5 ;
"""


def test_sass_counts_reads_warpgroup_products_and_tma_loads(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: None)
    monkeypatch.setattr(_build, "_tool", lambda name: name)
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 0, stdout=SASS_WGMMA))
    (name, ops), = _build.sass_counts("flash_fwd.cu").items()
    assert "flash_fwd_kernel" in name
    assert ops == {"HMMA": 1, "HGMMA": 3, "UTMALDG": 2, "FFMA": 1}


def test_built_with_makes_every_wrapper_load_the_variant(monkeypatch):
    # a test's variant (such as plain TF32) for every kernel within the block,
    # the default build outside it and wherever a caller names its macros
    base, variant = object(), object()
    monkeypatch.setitem(_build._loaded, ("vq.cu", ()), base)
    monkeypatch.setitem(_build._loaded, ("vq.cu", ("MMA_TF32_ONE_PASS",)), variant)
    assert _build.load("vq.cu") is base
    with _build.built_with(("MMA_TF32_ONE_PASS",)):
        assert _build.load("vq.cu") is variant
        assert _build.load("vq.cu", ()) is base
    assert _build.load("vq.cu") is base
