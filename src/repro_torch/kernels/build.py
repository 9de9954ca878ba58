"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, bound through ``ctypes``. Libraries land in
``build/torch_kernels/`` at the repo root, named by a hash of the sources
and the flags, so a changed source rebuilds and an unchanged one loads the
existing library. Builds happen at first use, never at import.

There is no fallback: a missing ``nvcc`` or a failed build raises with the
compiler's output.

    from repro_torch.kernels import build
    lib = build.load("flash_attention")   # ctypes.CDLL
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict = {}
build_seconds: dict = {}  # name -> seconds the last build took (0 = cached)
build_logs: dict = {}  # name -> nvcc's output (ptxas registers and spills)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "port's CUDA kernels are built at first use and need the CUDA toolkit")


def _lib_path(name: str, build_dir: Path) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names, build_dir=None) -> dict:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns {name: library path}."""
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    paths = {n: _lib_path(n, build_dir) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    for n in paths:
        build_seconds.setdefault(n, 0.0)
    if not todo:
        return paths
    nvcc = nvcc_path()
    build_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, cmd)
    failures = []
    for n, (proc, tmp, cmd) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
            continue
        os.replace(tmp, todo[n])  # atomic: readers never see half a library
        build_seconds[n] = time.perf_counter() - t0
        build_logs[n] = out
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load(name: str = "flash_attention", build_dir=None) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed (thread-safe)."""
    with _LOCK:
        key = (name, str(build_dir))
        lib = _LOADED.get(key)
        if lib is None:
            path = build_all([name], build_dir)[name]
            lib = ctypes.CDLL(str(path))
            _LOADED[key] = lib
        return lib
