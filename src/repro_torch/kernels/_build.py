"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and becomes its own shared
library, compiled by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at
the root of the checkout on first use.  A library's file name carries a
hash of its source and of the headers it includes (``csrc/*.cuh``), so an
edited kernel or header is rebuilt and a stale one never loads.
:func:`build_all` starts one ``nvcc`` per source at once.  Nothing is built
when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("decode_attention", "matmul", "conv2d", "wkv6", "linear_scan", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels build "
            "only where the CUDA toolkit is installed"
        )
    return str(path)


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: set[Path] | None = None) -> list[Path]:
    """``path`` and every file it includes with quotes, found beside it,
    recursively, each once."""
    seen = set() if seen is None else seen
    if path in seen:
        return []
    seen.add(path)
    out = [path]
    for inc in _INCLUDE.findall(path.read_bytes()):
        dep = path.parent / inc.decode()
        if dep.exists():
            out += _sources(dep, seen)
    return out


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources(CSRC / f"{name}.cu"):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start(name: str) -> subprocess.Popen | None:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish(name: str, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    _logs[name] = log
    tmp = Path(proc.args[proc.args.index("-o") + 1])
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, _target(name))


def build_all() -> dict[str, str]:
    """Compile every kernel source that has no current library, all
    ``nvcc`` processes in parallel; returns each fresh build's compiler
    log (``-Xptxas -v``: registers, shared memory, spills)."""
    with _lock:
        procs = {name: _start(name) for name in SOURCES}
        for name, proc in procs.items():
            _finish(name, proc)
        return {n: _logs[n] for n in SOURCES if n in _logs}


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``signatures`` maps each C entry point to its ctypes ``argtypes``
    (pointers as ``c_void_p``, so they are never cut to 32 bits); every
    entry point returns a ``cudaError_t`` as ``int``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
