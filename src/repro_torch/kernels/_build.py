"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each source has a plain C interface and becomes its own shared library,
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout, where
the hash covers the source, the local headers it includes, the flags and
the nvcc used.  A library that is already there is reused.  The build
happens at first use (the first launch on a CUDA tensor), never at import,
and a failed nvcc raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "rmsnorm", "ssd")
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    """Path of nvcc (``PATH``, then ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``); raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under $CUDA_HOME)")


def _sources(path: Path, seen: List[Path]) -> List[Path]:
    """``path`` and, depth first, every ``#include "..."`` under ``csrc/``
    that it reaches, each once."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in _LOCAL_INCLUDE.findall(path.read_text()):
        if (CSRC / inc).exists():
            _sources(CSRC / inc, seen)
    return seen


def library_path(name: str, nvcc: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes, named by a hash of
    the source, the local headers it includes, the flags and the
    compiler."""
    h = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu", []):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(os.path.realpath(nvcc).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, nvcc: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(name: str) -> Path:
    """Build the library of ``csrc/<name>.cu`` unless it is built already;
    returns its path.  nvcc's output goes to ``<library>.log``."""
    nvcc = find_nvcc()
    out = library_path(name, nvcc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(nvcc_command(name, nvcc, tmp), capture_output=True,
                         text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {res.returncode}, "
                           f"see {out.with_suffix('.log')})")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``.  Each
    kernel wrapper calls this once and keeps the function it binds."""
    return ctypes.CDLL(str(build(name)))
