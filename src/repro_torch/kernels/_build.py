"""Build the port's CUDA sources into plain-C shared libraries.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into ``build/lib<name>-<hash>.so`` at the repository root,
at first use, from the sources in the checkout only.  The hash covers
the source text and the flags, so an edited source rebuilds.  Libraries
are loaded with ``ctypes``; a process loads each one once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # exact float semantics: the kernels must equal their plain versions
    "-fmad=false",
    "-Xptxas", "-v",
)

# (library, seconds the build took, compiler log); filled at first use
_LOADED: Dict[str, Tuple[ctypes.CDLL, float, str]] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under /usr/local/cuda; the CUDA "
            "kernels are built on the machine with the card"
        )
    return path


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Tuple[Path, float, str]:
    """Compile ``source`` unless its library exists; returns (path,
    seconds spent compiling, compiler log)."""
    out = library_path(source)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    return out, secs, log


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``source``."""
    key = str(source)
    if key not in _LOADED:
        path, secs, log = build(source)
        _LOADED[key] = (ctypes.CDLL(str(path)), secs, log)
    return _LOADED[key][0]


def build_info(source: Path) -> Tuple[float, str]:
    """(build seconds, compiler log) of a library this process loaded."""
    _, secs, log = _LOADED[str(source)]
    return secs, log
