"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled at first use with ``nvcc`` into a
shared library with a plain C interface, and loaded with ``ctypes``. The
library lands in ``build/kernels/`` at the root of the checkout, named by a
hash of its source, the ``csrc/`` headers it includes (``#include "..."``)
and the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is. A failed build raises with the
compiler's output. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from collections.abc import Iterable, Iterator, Mapping
from contextlib import contextmanager
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES: dict[str, str] = {"ell_spmm": "ell_spmm.cu",
                           "ell_spmm_sliced": "ell_spmm_sliced.cu",
                           "ell_spmv": "ell_spmv.cu",
                           "walk_gather": "walk_gather.cu",
                           "flash_attention": "flash_attention.cu",
                           "flash_attention_bwd": "flash_attention_bwd.cu",
                           "embedding_bag": "embedding_bag.cu",
                           "embedding_bag_grad": "embedding_bag_grad.cu",
                           "endpoint_fold": "endpoint_fold.cu",
                           "segment_reduce": "segment_reduce.cu",
                           "segment_grad": "segment_grad.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda``,
    then ``PATH``. Raises when there is none."""
    homes = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built")
    return found


_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.MULTILINE)


def library_path(name: str) -> Path:
    text = (CSRC / SOURCES[name]).read_bytes()
    headers = sorted(set(_INCLUDE.findall(text)))
    content = text + b"".join((CSRC / h.decode()).read_bytes()
                              for h in headers)
    digest = hashlib.sha256(content
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def built(names: Iterable[str] | None = None) -> bool:
    """Whether every named source (default: all) already has its library
    for the current sources and flags, so that no ``nvcc`` would run."""
    return all(library_path(name).exists()
               for name in (SOURCES if names is None else names))


def build(names: Iterable[str] | None = None) -> dict[str, Path]:
    """Compile every named source that has no library yet, one ``nvcc``
    each, all started together. Returns name -> library path."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, target)
    for name, (proc, tmp, target) in pending.items():
        out, _ = proc.communicate()
        log_path(name).write_text(out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, target)
    return {name: library_path(name) for name in names}


def load(name: str,
         signatures: Mapping[str, tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed, with
    ``argtypes``/``restype`` set from ``signatures`` (function name ->
    (argtypes, restype))."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


@contextmanager
def on_card(device: torch.device) -> Iterator[int]:
    """Launch through one of these libraries on ``device``: a library with
    a plain C interface launches on the thread's current card, and its
    stream handle 0 is that card's default stream, so ``device`` is made
    the current card for the call (as it was before on exit), and the
    handle of its current stream is yielded."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream
