"""Build the port's CUDA sources into plain-C shared libraries.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into ``build/lib<name>-<hash>.so`` at the repository root,
at first use, from the sources in the checkout only.  The hash covers
the source text and the flags, so an edited source rebuilds.  Libraries
are loaded with ``ctypes``; a process loads each one once.
:func:`build_all` compiles several sources at once, one ``nvcc``
process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# exact float semantics, for a kernel that must equal its plain version
# bit for bit; kernels held to a tolerance build without it
EXACT_FLAGS = ("-fmad=false",)

# source -> (seconds the build took, compiler log); 0 s if it was built
_BUILT: Dict[str, Tuple[float, str]] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under /usr/local/cuda; the CUDA "
            "kernels are built on the machine with the card"
        )
    return path


def library_path(source: Path, flags: Sequence[str] = ()) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join((*NVCC_FLAGS, *flags)).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all(
    specs: Sequence[Tuple[Path, Sequence[str]]],
) -> Dict[str, Tuple[float, str]]:
    """Compile every ``(source, extra flags)`` whose library does not
    exist, all ``nvcc`` processes at once (one for sources of the same
    text and flags); returns source -> (seconds its compile took,
    compiler log)."""
    started, same = [], {}
    for source, flags in specs:
        out = library_path(source, flags)
        if out in same:  # the same library as another source's
            same[out].append(source)
            continue
        if out.exists():
            _BUILT.setdefault(str(source), (0.0, ""))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        same[out] = [source]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started.append((source, out, tmp, proc, time.perf_counter()))
    failed = []
    for source, out, tmp, proc, t0 in started:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {source}:"
                          f"\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
        for s in same[out]:
            _BUILT[str(s)] = (secs, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {str(s): _BUILT[str(s)] for s, _ in specs}


def load(source: Path, flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``source``."""
    key = str(source)
    if key not in _LOADED:
        build_all([(source, flags)])
        _LOADED[key] = ctypes.CDLL(str(library_path(source, flags)))
    return _LOADED[key]


def build_info(source: Path) -> Tuple[float, str]:
    """(build seconds, compiler log) of a library this process built or
    found built."""
    return _BUILT[str(source)]
