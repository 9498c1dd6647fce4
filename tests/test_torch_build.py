"""The kernel build's cache key (mxnet_tpu_torch.cuda_build._target): a
library's file name digests its own source, every shared header under
``csrc/`` and the nvcc flags, so editing a header that two kernels
include rebuilds both.  No nvcc is needed: only the names are computed.
"""
from mxnet_tpu_torch import cuda_build


def _write(path, text):
    path.write_text(text)


def test_header_edit_changes_every_target(tmp_path, monkeypatch):
    _write(tmp_path / "one.cu", '#include "shared.cuh"\nint one;\n')
    _write(tmp_path / "two.cu", '#include "shared.cuh"\nint two;\n')
    _write(tmp_path / "shared.cuh", "// tiles v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    before = {n: cuda_build._target(n) for n in ("one", "two")}
    assert before["one"] != before["two"]
    assert before == {n: cuda_build._target(n) for n in ("one", "two")}

    _write(tmp_path / "shared.cuh", "// tiles v2\n")
    after = {n: cuda_build._target(n) for n in ("one", "two")}
    assert all(after[n] != before[n] for n in after)

    # a source edit moves only its own library
    _write(tmp_path / "one.cu", '#include "shared.cuh"\nint one = 1;\n')
    again = {n: cuda_build._target(n) for n in ("one", "two")}
    assert again["one"] != after["one"] and again["two"] == after["two"]


def test_new_header_and_flags_change_the_target(tmp_path, monkeypatch):
    _write(tmp_path / "one.cu", "int one;\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    base = cuda_build._target("one")
    _write(tmp_path / "extra.cuh", "// new\n")
    with_header = cuda_build._target("one")
    assert with_header != base
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ["-lineinfo"])
    assert cuda_build._target("one") != with_header


def test_repository_sources_share_the_tile_header():
    import os

    src = cuda_build.CSRC
    for name in ("fused_fwd", "fused_bwd"):
        with open(os.path.join(src, name + ".cu")) as f:
            assert '#include "fused_tiles.cuh"' in f.read()
    assert set(cuda_build.SOURCES) >= {"fused_fwd", "fused_bwd"}
