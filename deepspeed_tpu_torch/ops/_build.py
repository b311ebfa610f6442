"""Build and load the port's CUDA kernels (`deepspeed_tpu_torch/csrc`).

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own
shared library with a plain C interface, loaded with `ctypes` (no PyTorch
headers, so a build takes seconds).  Libraries land in
`build/torch_kernels/<hash>/` beside the package (listed in `.gitignore`),
keyed by a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one loads from disk.  Nothing builds at import: the first
wrapper call on a CUDA tensor builds every kernel at once, one `nvcc`
process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict

__all__ = ["KERNELS", "build_all", "load", "library_path", "function",
           "check"]

KERNELS = ("flash_fwd", "flash_bwd", "paged_decode", "paged_decode_wide",
           "paged_prefill", "lora_delta", "fused_adam8", "sparse_flash",
           "evoformer_flash", "tile_matmul", "moe_grouped")
# libraries built from another library's source with extra flags: the
# paged decode's template builds at head dims 80 and 96, compiled beside
# those at 32, 64 and 128 by a process of their own
_VARIANTS = {"paged_decode_wide": ("paged_decode", ("-DDSTT_DECODE_WIDE",))}

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's kernels are built from "
        "deepspeed_tpu_torch/csrc on first use")


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + repr(_VARIANTS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return _build_dir() / f"lib{name}.so"


def build_all(names=KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, all `nvcc`
    processes in parallel.  Returns {name: seconds} for the kernels built
    by this call (the compiler's register/shared-memory report is kept
    beside each library as `<name>.ptxas.txt`).  Raises with the
    compiler's output on any failure."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        src, extra = _VARIANTS.get(name, (name, ()))
        cmd = [nvcc, *_FLAGS, *extra, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / f"{src}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    times, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        (out_dir / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building all kernels first if
    any is missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all()
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes):
    """C entry point `symbol` of kernel library `name`, with its ctypes
    argument types declared (pointers and the stream as c_void_p, so no
    64-bit value is cut to a C int) and an int (CUDA error code) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
