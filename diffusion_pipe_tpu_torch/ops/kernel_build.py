"""Builds the CUDA sources under csrc/ with nvcc and loads them with ctypes.

Each source becomes its own shared library with a plain C interface, built
at first use into build/kernels/ at the repository root (listed in
.gitignore). The file name carries a hash of the sources and the nvcc
command, so an edited kernel is rebuilt and an unchanged one is reused. All
sources build in parallel, one nvcc process each. Nothing here runs when the
module is imported.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# library name -> source file; the flash sources also include the headers,
# which are hashed into every library's name
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "flash_bwd_dkv": "flash_bwd_dkv.cu",
    "flash_bwd_dkv_d256": "flash_bwd_dkv_d256.cu",
    "stochastic_round": "stochastic_round.cu",
    "int8_quant": "int8_quant.cu",
}
HEADERS = ("flash_common.cuh", "hopper_common.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name], *HEADERS):
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Build every missing library, one nvcc each, all started together.

    Returns {name: {"seconds", "cached", "ptxas"}} and raises with nvcc's
    output if any build fails. nvcc's output (the ptxas register and spill
    lines) is kept beside each library, so a cached build reports it too.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    report: Dict[str, dict] = {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        target = _target(name)
        if target.exists():
            log = target.with_suffix(".log")
            report[name] = {"seconds": 0.0, "cached": True,
                            "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                        "ptxas": out}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building all kernels on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all()
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib
