"""Build and load the port's hand-written CUDA kernels.

Every kernel source under ``kernels/*/csrc/*.cu`` has a plain C
interface and is compiled with ``nvcc`` into its own shared library for
Hopper (``sm_90a``), then loaded with ``ctypes``.  Libraries are built
at first use into ``kernels/_build/`` (listed in ``.gitignore``), named
by a hash of the source and flags, so an edited source rebuilds and an
unchanged one loads at once.  A build writes to a temporary name and
renames it into place, so concurrent processes never load a half-written
library.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def kernel_sources() -> Tuple[Path, ...]:
    """Every CUDA source of the port, in a stable order."""
    return tuple(sorted(KERNELS_DIR.glob("*/csrc/*.cu")))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source at first use")
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def _start(source: Path):
    """Start nvcc for ``source`` unless its library exists; returns
    ``(library, tmp, process or None)``."""
    lib = library_path(source)
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                             str(source)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def build(sources: Sequence[Path] = ()) -> Dict[str, str]:
    """Build every source (all ``nvcc`` processes started together) and
    return ``{source name: compiler output}``; raises if one fails."""
    started = [(s, *_start(s)) for s in (sources or kernel_sources())]
    logs, failed = {}, []
    for src, lib, tmp, proc in started:
        if proc is None:
            logs[src.name] = "(cached)"
            continue
        out, _ = proc.communicate()
        logs[src.name] = out
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))
