"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each source under csrc/ is compiled by nvcc for sm_90a into a shared library
under build/scalellm_tpu_torch/ at the repository root, the first time it is
needed. The library's file name carries a hash of its source and of the
shared headers (csrc/*.cuh), so an edited source or header is rebuilt and a
stale library is never loaded. The build runs only
when a kernel is launched or build() is called, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "scalellm_tpu_torch"

# Kernel name -> source file in csrc/.
SOURCES = {
    "ragged_paged_attention": "ragged_paged_attention.cu",
    "ragged_paged_attention_f32": "ragged_paged_attention_f32.cu",
    "quant_matmul": "quant_matmul.cu",
    "grouped_matmul": "grouped_matmul.cu",
    "mla_attention": "mla_attention.cu",
    "moe_quant": "moe_quant.cu",
    "quant_gemv": "quant_gemv.cu",
    "quant_mlp": "quant_mlp.cu",
    "expert_dequant": "expert_dequant.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source and the shared
    headers of csrc/ (a source may include any of them)."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, float]:
    """Compile every named kernel whose library is missing (every named
    kernel with force), one nvcc per source, all started together. Returns
    seconds per kernel built; the compiler's resource report goes to
    <library>.log."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.monotonic()
    for name in names:
        lib = library_path(name)
        if lib.exists() and not force:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, lib)
    seconds = {}
    failed = []
    for name, (proc, tmp, lib) in jobs.items():
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        seconds[name] = time.monotonic() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
