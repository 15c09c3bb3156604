"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
are built at first use, from the sources in this checkout only, into
``_build/`` beside the package (listed in ``.gitignore``); the file name
carries a hash of the source, every ``csrc/*.cuh`` header and the flags
(global and the source's own), so an edited source, header or flag
rebuilds. ``build()`` compiles several sources in parallel, one ``nvcc``
each.

Nothing here touches CUDA when the module is imported, so the CPU tests can
import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source, after it on the command line: K3, K4 and K5 encode TMA
# tensor maps with cuTensorMapEncodeTiled, which libcuda provides; the stager
# keeps every fp32 product and sum rounded on its own (no FMA contraction), as
# the host library it replaces computes
SOURCE_FLAGS: Dict[str, tuple] = {name: ("-lcuda",) for name in ("decode", "bin_decode", "fused_conv")}
SOURCE_FLAGS["staging"] = ("-fmad=false",)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points of each source: name -> argtypes (all return a cudaError_t as int)
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "decode": {
        "decode_level": (_P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L,
                         ctypes.POINTER(_F), _I, _F, _P),
        "decode_levels_tma": (_I, ctypes.POINTER(_L), ctypes.POINTER(_F), _P, _I, _I, _L, _I, _P),
    },
    "nms": {
        "nms_suppress": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
        "nms_launch_floor": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
        "nms_suppress_tiled": (_P, _P, _P, _P, _P, _L, _I, _I, _F, _P),
        "nms_tiled_mask": (_P, _P, _P, _P, _P, _L, _I, _I, _F, _P),
        "nms_tiled_sweep": (_P, _P, _P, _P, _P, _L, _I, _I, _F, _P),
    },
    "bin_decode": {
        "decode_level_bin": (_P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L,
                             ctypes.POINTER(_F), _I, _I, _F, _P),
        "decode_levels_bin_tma": (_I, ctypes.POINTER(_L), ctypes.POINTER(_F), _P, _I, _I, _L, _I,
                                  _I, _P),
    },
    "fused_conv": {
        "fused_conv_bf16_wgmma": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "fused_conv_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "fused_conv_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "fused_conv_check_rcp": (ctypes.c_uint, ctypes.c_uint, _P, _P),
    },
    "staging": {
        "stage_letterbox": (_P, _P, _P, _I, _I, _P),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the port's CUDA kernels "
                       "are built from csrc/ at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + ("--",) + SOURCE_FLAGS.get(name, ())).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together. Returns each new build's compiler log (ptxas
    registers and shared memory per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *SOURCE_FLAGS.get(name, ())]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
