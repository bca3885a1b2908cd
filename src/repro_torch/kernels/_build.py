"""Build and load of the port's hand-written CUDA kernels.

Each kernel package keeps its source under ``csrc/``: CUDA C++ for
Hopper (``sm_90a``) with a plain C interface.  Headers the sources share
(the PTX wrappers) live in ``kernels/csrc/``, passed to ``nvcc`` with
``-I``.  `build` compiles one source with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into a
shared library keyed by a hash of the source, every header it includes
with quotes (recursively) and the flags, under ``build/repro_torch/`` at
the repository root; `load` opens it with ``ctypes`` once per process.
Nothing is built or loaded at import: the kernel modules import on a
machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, List

INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_LIBS: Dict[Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                       "CUDA kernels cannot be built")


def included_files(source: Path) -> List[Path]:
    """``source`` and every file it includes with quotes, recursively,
    found beside the including file or in `INCLUDE_DIR` (as ``nvcc``
    looks for them); each once, in the order first met."""
    seen: List[Path] = []
    todo = [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            for base in (path.parent, INCLUDE_DIR):
                cand = (base / name).resolve()
                if cand.exists():
                    todo.append(cand)
                    break
            else:
                raise FileNotFoundError(f"{path.name} includes {name!r}, "
                                        f"found neither beside it nor in "
                                        f"{INCLUDE_DIR}")
    return seen


def library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in included_files(source):
        h.update(path.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless a library for it exists; returns the
    library's path.  Safe to call from several threads or processes at
    once (each compiles to a temporary file and renames it)."""
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{INCLUDE_DIR}", "-o", tmp, str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(source: Path, declare: Callable[[ctypes.CDLL], None]
         ) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use), with
    ``declare(lib)`` having set every function's argtypes/restype."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            declare(lib)
            _LIBS[source] = lib
        return lib
