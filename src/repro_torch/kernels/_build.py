"""Build and load the port's hand-written CUDA kernels.

Every kernel source under ``kernels/*/csrc/*.cu`` has a plain C
interface and is compiled with ``nvcc`` into its own shared library for
Hopper (``sm_90a``), then loaded with ``ctypes``; a source named in
``SPLITS`` is compiled into one library per value of its macro instead,
each holding that part of its instances, so that its parts compile in
parallel.  Libraries are built at first use into ``kernels/_build/``
(listed in ``.gitignore``), named by a hash of the source and flags, so
an edited source rebuilds and an unchanged one loads at once.  A build
writes to a temporary name of its process and thread and renames it
into place, so concurrent builds never load a half-written library.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# source name -> (macro, its values): one library a value.  K3's 120
# kernels (5 head dims x 6 GQA groups x 2 dtypes, split and combine) took
# most of the build's wall time in one nvcc.
SPLITS = {"flash_decode_paged.cu": ("FD_HEAD_DIM", (32, 64, 80, 128, 256))}

Unit = Tuple[Path, Optional[str]]      # (source, "MACRO=value" or None)


def kernel_sources() -> Tuple[Path, ...]:
    """Every CUDA source of the port, in a stable order."""
    return tuple(sorted(KERNELS_DIR.glob("*/csrc/*.cu")))


def units(sources: Sequence[Path]) -> Tuple[Unit, ...]:
    """The libraries ``sources`` build to: one a source, or one a value
    of its ``SPLITS`` macro."""
    out = []
    for src in sources:
        macro, values = SPLITS.get(src.name, (None, (None,)))
        out += [(src, None if v is None else f"{macro}={v}") for v in values]
    return tuple(out)


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


def _flags(define: Optional[str]) -> Tuple[str, ...]:
    return NVCC_FLAGS + ((f"-D{define}",) if define else ())


def library_path(source: Path, define: Optional[str] = None) -> Path:
    """The library of one unit; raises unless ``define`` is one of the
    source's ``SPLITS`` values, or None for a source that is not split."""
    macro, values = SPLITS.get(source.name, (None, (None,)))
    if define not in [None if v is None else f"{macro}={v}" for v in values]:
        raise ValueError(f"{source.name} builds with "
                         + (f"{macro}= one of {values}" if macro else
                            "no define") + f", not {define!r}")
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(_flags(define)).encode()).hexdigest()
    part = "" if define is None else "-" + define.split("=")[1]
    return BUILD_DIR / f"{source.stem}{part}-{digest[:16]}.so"


def _start(source: Path, define: Optional[str]):
    """Start nvcc for the unit unless its library exists; returns
    ``(library, tmp, process or None)``."""
    lib = library_path(source, define)
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    proc = subprocess.Popen([nvcc_path(), *_flags(define), "-o", str(tmp),
                             str(source)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _build_units(todo: Sequence[Unit]) -> Dict[str, str]:
    started = [(src, define, *_start(src, define)) for src, define in todo]
    logs, failed = {}, []
    for src, define, lib, tmp, proc in started:
        name = src.name if define is None else f"{src.name} [{define}]"
        if proc is None:
            logs[name] = "(cached)"
            continue
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def build(sources: Sequence[Path] = ()) -> Dict[str, str]:
    """Build every library of ``sources`` (all ``nvcc`` processes started
    together) and return ``{library name: compiler output}``; raises if
    one fails."""
    return _build_units(units(sources or kernel_sources()))


@functools.lru_cache(maxsize=None)
def load(source: Path, define: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library of ``source`` (of its ``define`` part, for a
    source in ``SPLITS``), built first if needed."""
    _build_units([(source, define)])
    return ctypes.CDLL(str(library_path(source, define)))
