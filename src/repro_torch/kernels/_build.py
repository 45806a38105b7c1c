"""Builds and loads the CUDA kernels of this package.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface and loaded with ``ctypes`` —
no PyTorch headers, so a cold build takes seconds. The build happens at
first use (never at import: hosts without a CUDA toolkit import every
module of this package) into ``build/repro_torch/`` beside the source
tree. The library's name carries a hash of the sources and flags, so an edited kernel is never answered from
a stale build. One ``nvcc -c`` runs per source, all started together, then
one link.

There is no fallback: a missing compiler, a failed build or a failed load
raises, and the kernel wrappers let that propagate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

__all__ = ["library", "build_report", "SOURCES", "NVCC_FLAGS"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "xor_fold.cu",
    "gather_xor.cu",
    "indices_from_mask.cu",
    "fused_gather_fold.cu",
    "fused_multi_gather_fold.cu",
    "parity_matmul.cu",
    "scatter_rows.cu",
    "sparse_masks.cu",
    "flash_attention.cu",
    "flash_attention_wgmma.cu",
)
HEADERS = ("common.cuh", "fused_slab.cuh", "sm90.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argument types (every one returns a cudaError_t, but
# pir_fused_active_clusters, a count)
_SIGNATURES = {
    "pir_xor_fold": (_P, _P, _P, _I, _I, _I, _P),
    "pir_xor_fold_table": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pir_gather_xor": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "pir_indices_from_mask": (_P, _P, _P, _I, _I, _I, _P),
    "pir_fused_gather_fold": (
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "pir_fused_multi_gather_fold": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "pir_fused_active_clusters": (_I, _I),
    "pir_parity_matmul": (_P, _L, _P, _L, _P, _L, _I, _I, _I, _I, _I, _P),
    "pir_scatter_rows": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "pir_sparse_masks": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # ... causal, window, q_offset, softcap[, dtype], stream
    "pir_flash_attention_fwd": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
    ),
    "pir_flash_attention_wgmma": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_report: Dict[str, object] = {}


def _build_dir() -> pathlib.Path:
    # src/repro_torch/kernels/_build.py -> the tree's root
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked at CUDA_HOME, PATH and /usr/local/cuda): "
        "the CUDA kernels of repro_torch cannot be built on this host"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


_PTXAS_FN = re.compile(r"Compiling entry function '([^']+)' for 'sm_90a'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")
_PTXAS_SPILL = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
)
# what ptxas says beyond the counts: warnings, and its advisories (e.g.
# wgmma instructions serialized for a register hazard)
_PTXAS_NOTE = re.compile(r"warning|Performance Loss", re.IGNORECASE)


def _parse_ptxas(source: str, text: str) -> List[Dict[str, object]]:
    """One record per compiled entry function from ``-Xptxas -v`` output."""
    out: List[Dict[str, object]] = []
    cur: Optional[Dict[str, object]] = None
    for line in text.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            cur = {"source": source, "entry": m.group(1), "registers": None,
                   "smem_bytes": 0, "spill_store_bytes": 0,
                   "spill_load_bytes": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur["spill_store_bytes"] = int(m.group(2))
            cur["spill_load_bytes"] = int(m.group(3))
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _PTXAS_SMEM.search(line)
            if s:
                cur["smem_bytes"] = int(s.group(1))
    return out


def _build(lib_path: pathlib.Path) -> None:
    nvcc = _find_nvcc()
    out_dir = lib_path.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = out_dir / f"{lib_path.stem}.{name}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    kernels: List[Dict[str, object]] = []
    notes: List[str] = []
    failures = []
    for name, obj, proc in procs:  # wait for every child before raising
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{text}")
        kernels.extend(_parse_ptxas(name, text))
        notes.extend(f"{name}: {line.strip()}" for line in text.splitlines()
                     if _PTXAS_NOTE.search(line))
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    _report.update(
        built=True, seconds=time.perf_counter() - t0, nvcc=nvcc,
        kernels=kernels, notes=notes,
    )


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = _build_dir() / f"librepro_torch_kernels_{_source_hash()}.so"
        _report.update(library=str(lib_path), built=False, seconds=0.0,
                       kernels=[], notes=[])
        if not lib_path.is_file():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def build_report() -> Dict[str, object]:
    """What the last :func:`library` call did: the library's path, whether
    it compiled (and the seconds that took) or reused a build, what
    ``ptxas -v`` said of each kernel (registers, shared memory, spills),
    and the compilers' warnings and advisories (``notes``)."""
    return dict(_report)
