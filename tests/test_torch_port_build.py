"""The port's kernel build (``kernels/_build.py``), without nvcc.

A built library is named by a hash of everything that goes into it: its
source, the ``csrc/*.cuh`` headers it may include, the global nvcc flags and
its own flags. An edit to any of them must give a new name, or a stale
library would load. The C entry points of every source must match the
ctypes signatures the wrappers call them with.
"""
import re
import subprocess

import pytest

from yolo_continuous_tpu_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ of one source that includes one header, and no source flags."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\nextern "C" int k(int n) { return n; }\n')
    (tmp_path / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "SOURCE_FLAGS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_the_name_is_stable(csrc):
    path = _build.library_path("k")
    assert path == _build.library_path("k")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libk-")


@pytest.mark.parametrize("edit", ["source", "included header", "new header", "source flag",
                                  "global flag"])
def test_the_name_changes_with_every_input(csrc, monkeypatch, edit):
    before = _build.library_path("k")
    if edit == "source":
        (csrc / "k.cu").write_text((csrc / "k.cu").read_text() + "// edited\n")
    elif edit == "included header":
        (csrc / "common.cuh").write_text("#pragma once\n#define TILE 64\n")
    elif edit == "new header":
        (csrc / "tiles.cuh").write_text("#pragma once\n")
    elif edit == "source flag":
        monkeypatch.setitem(_build.SOURCE_FLAGS, "k", ("-lcuda",))
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("k") != before


def test_another_sources_flags_leave_the_name(csrc, monkeypatch):
    before = _build.library_path("k")
    monkeypatch.setitem(_build.SOURCE_FLAGS, "other", ("-lcuda",))
    assert _build.library_path("k") == before


def test_the_source_flags_follow_the_source_on_the_nvcc_line(csrc, monkeypatch):
    """Libraries are linked after the source that needs them."""
    monkeypatch.setitem(_build.SOURCE_FLAGS, "k", ("-lcuda",))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmds = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            cmds.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            return ("ptxas info: 0 registers", None)

    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    logs = _build.build(["k"])
    (cmd,) = cmds
    assert cmd[0] == "nvcc" and cmd[-2:] == [str(csrc / "k.cu"), "-lcuda"]
    assert logs == {"k": "ptxas info: 0 registers"} and _build.library_path("k").exists()
    assert _build.build(["k"]) == {} and len(cmds) == 1       # built once


def _entry_points(source: str):
    """name -> number of parameters of each ``extern "C"`` function."""
    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source)
    return {name: len(params.split(",")) for name, params in found}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_c_entry_points(name):
    entry = _entry_points((_build.CSRC / f"{name}.cu").read_text())
    assert {fn: len(args) for fn, args in _build.SIGNATURES[name].items()} == entry


def test_every_source_is_built_and_k5_links_libcuda():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(_build.SIGNATURES)
    assert set(_build.SOURCE_FLAGS) <= set(_build.SIGNATURES)
    assert _build.SOURCE_FLAGS["fused_conv"] == ("-lcuda",)
