"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``; a
source may hold several entry points (``xmodal_score.cu`` and
``moe_dispatch.cu`` hold two each). Builds
happen at first use into ``build/kernels/`` at the repository root (listed
in ``.gitignore``); a library's file name carries a hash of its sources and
flags, so an edited kernel rebuilds and an unchanged one loads as is.
``build_all`` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# the extern "C" entry points: name -> (source in csrc/, C signature with
# pointers as c_void_p: a bare Python int would be passed as a 32-bit int
# and cut the address)
KERNELS = {
    "flash_attention": ("flash_attention", [_P] * 5 + [_I] * 8 + [_P]),
    "decode_attention": ("decode_attention", [_P] * 6 + [_I] * 8 + [_P]),
    "paged_decode_attention": ("paged_decode_attention",
                               [_P] * 9 + [_I] * 11 + [_P]),
    "xmodal_score_mean": ("xmodal_score", [_P] * 6 + [_I] * 5 + [_P]),
    "xmodal_score_max": ("xmodal_score", [_P] * 5 + [_I] * 7 + [_P]),
    "moe_dispatch": ("moe_dispatch", [_P] * 3 + [_I] * 6 + [_P]),
    "moe_combine": ("moe_dispatch", [_P] * 4 + [_I] * 6 + [_P]),
}
SOURCES = sorted({src for src, _ in KERNELS.values()})

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}
# per-source build record: seconds spent in nvcc (0 when the library was
# already built) and the compiler's -Xptxas -v report
BUILD_INFO: Dict[str, Dict[str, object]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    """The library of source ``name``; its file name carries a hash of the
    sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, out path, t0)
    or None when the library is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": secs, "log": log}


def build_all(names: List[str] = None) -> Dict[str, Dict[str, object]]:
    """Compile every source (or the sources ``names``) in parallel;
    returns BUILD_INFO."""
    names = SOURCES if names is None else names
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])
    return {n: BUILD_INFO[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The library of source ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def function(name: str):
    """The C entry point ``name`` with its signature, its library built on
    first use."""
    fn = _FNS.get(name)
    if fn is None:
        src, argtypes = KERNELS[name]
        fn = getattr(load(src), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn
