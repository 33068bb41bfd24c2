"""The kernels' build cache: a library's file name follows its source, every
shared header in csrc/ and the nvcc flags, so that an edited header is not
served from a stale library. CPU only: nothing is compiled."""

import pytest

from hupr_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kernel.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    return tmp_path


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_library_path_follows_sources_and_headers(csrc, edit):
    before = cuda_build.library_path("kernel")
    assert before == cuda_build.library_path("kernel")   # stable
    if edit == "header":
        (csrc / "common.cuh").write_text("// v2\n")
    elif edit == "new_header":
        (csrc / "extra.cuh").write_text("// v1\n")
    else:
        (csrc / "kernel.cu").write_text('#include "common.cuh"\n// v2\n')
    after = cuda_build.library_path("kernel")
    assert after != before
    assert after.parent == cuda_build.BUILD_DIR
    assert after.name.startswith("libkernel-") and after.suffix == ".so"


def test_library_path_follows_flags(csrc, monkeypatch):
    before = cuda_build.library_path("kernel")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("kernel") != before


def test_shipped_sources_include_only_shipped_headers():
    """Every header a csrc source includes with quotes is a csrc/*.cuh, so
    that library_path hashes it."""
    import re

    headers = {p.name for p in cuda_build.CSRC.glob("*.cuh")}
    assert "hopper.cuh" in headers
    for src in cuda_build.CSRC.glob("*.cu*"):
        for name in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert name in headers, (src.name, name)
