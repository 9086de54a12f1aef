"""Compile ``csrc/*.cu`` with nvcc into shared libraries and load them with
ctypes.

Each source builds into ``tensorflowasr_tpu_torch/build/lib<name>-<hash>.so``
at first use; the hash covers the sources and the flags, so an edited
kernel rebuilds and an unchanged one loads from the earlier build. The
libraries expose a plain C interface: every pointer and the stream pass as
``ctypes.c_void_p``. Nothing here runs at import time, so the CPU-only
test host imports the package without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("power_spectrogram",)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels are built from csrc/ at first use and need the CUDA "
        "toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, all started together. Returns {name: nvcc's
    stderr} (the ``-Xptxas -v`` register/shared-memory report) for the
    sources built now; raises with nvcc's stderr if one fails."""
    pending = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        pending.append((name, proc, tmp, target))
    logs, failures = {}, []
    for name, proc, tmp, target in pending:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit "
                            f"{proc.returncode}):\n{out}{err}")
            continue
        os.replace(tmp, target)
        logs[name] = out + err
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            path = library_path(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
            _loaded[name] = lib
        return lib

