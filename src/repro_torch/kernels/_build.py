"""Build the CUDA sources under ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface,
``build/repro_torch_kernels/lib<name>.so`` under the checkout, at first
use; all sources that need building start together, one ``nvcc`` each.
A library newer than its sources is reused.  Nothing here includes
PyTorch's headers, so a build takes seconds.  Building raises when
``nvcc`` is missing or the compiler fails: a kernel is never silently
replaced by its plain version.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# src/repro_torch/kernels/_build.py -> the checkout root is three levels up
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("flash_attention", "paged_decode", "flash_decode", "paged_verify")
# -Xptxas -v: each kernel's registers, shared memory and spills, in the
# compiler output that ``build`` returns
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], Callable[..., int]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels build only where the CUDA toolkit is")
    return found


def _lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in
                 [_CSRC / f"{name}.cu", *_CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES, *,
          force: bool = False) -> Dict[str, str]:
    """Compile ``names`` (those older than their sources, or all with
    ``force``) in parallel; returns each one's compiler output.  Raises
    ``RuntimeError`` with the compiler's output when any build fails."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu "
                          f"(exit {p.returncode}):\n{out}")
        else:   # atomic rename: a reader never sees half a library
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def function(name: str, symbol: str,
             argtypes: Sequence) -> Callable[..., int]:
    """The C function ``symbol`` of library ``name``, built and resolved on
    the first call and taken from a cache after that, with its argument
    types declared (each pointer and the stream as ``c_void_p``, so ctypes
    never truncates them to 32 bits)."""
    fn = _functions.get((name, symbol))
    if fn is None:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(_loaded[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn
