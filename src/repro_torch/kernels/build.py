"""Build the hand-written CUDA kernels with ``nvcc`` and load them.

Each ``repro_torch/csrc/*.cu`` compiles to its own shared library with a
plain C interface (bound with ``ctypes`` in ``kernels/cuda.py``); the ``nvcc``
processes all start together.  Output goes to ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``); a library is rebuilt when
its source or the shared header is newer.  No fast math: the LSQ and KV
quantizers need IEEE division and ``rintf``.

    python -c "from repro_torch.kernels import build; print(build.build())"
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("quant_matmul", "kv_decode_attention", "flash_attention",
           "lsq_fakequant", "entropy_hist")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA "
                           f"kernels build only where the CUDA toolkit is "
                           f"installed")
    return str(path)


def _stale(lib: Path, src: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(src.stat().st_mtime, (CSRC / "common.cuh").stat().st_mtime)
    return lib.stat().st_mtime < newest


def build(out_dir: Optional[Path] = None) -> Dict[str, dict]:
    """Compile every stale kernel library in parallel.

    Returns {name: {"path", "seconds", "log"}}; ``log`` holds nvcc's output
    (``-Xptxas -v`` register and shared-memory counts).  Raises with the
    compiler output if any source fails to build.
    """
    out_dir = Path(out_dir) if out_dir is not None else BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        src, lib = CSRC / f"{name}.cu", out_dir / f"lib{name}.so"
        if not _stale(lib, src):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out_dir / f"lib{name}.so.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    result: Dict[str, dict] = {}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        result[name] = {"path": str(lib), "log": log,
                        "seconds": time.perf_counter() - t0}
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{log}")
        else:
            tmp.replace(lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in SOURCES:
        result.setdefault(name, {"path": str(out_dir / f"lib{name}.so"),
                                 "log": "", "seconds": 0.0})
    return result


_LIBS: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building all stale ones first."""
    if name not in _LIBS:
        info = build()
        _LIBS[name] = ctypes.CDLL(info[name]["path"])
    return _LIBS[name]
