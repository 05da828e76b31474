"""Builds the port's CUDA sources with ``nvcc`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for Hopper
(``sm_90a``) into ``gantron_tpu_torch/_build/<name>-<hash>.so``, the hash
covering the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built at import time: the first wrapper
call on a CUDA tensor builds what it needs, and ``build`` can start several
``nvcc`` processes at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}
# name -> {"seconds": wall time of the nvcc run, "ptxas": its register and
# shared-memory report}; empty for a library found already built.
build_log = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "gantron_tpu_torch are built at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(*names: str) -> None:
    """Compile every named source not yet built, all ``nvcc`` runs at once.
    Raises with the compiler's output if any of them fails."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{out}")
            continue
        os.replace(tmp, _target(name))  # atomic: concurrent builds agree
        build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` as a ``ctypes`` library, built if needed."""
    if name not in _libs:
        build(name)
        _libs[name] = ctypes.CDLL(str(_target(name)))
    return _libs[name]
