"""Build and load the CUDA kernel libraries.

Each kernel is one `csrc/<name>.cu` file with a plain C interface. At
first use it is compiled by `nvcc` for `sm_90a` into a shared library
under `build/repro_torch_kernels/` at the root of the checkout (a
directory `.gitignore` lists), named by a hash of its sources and
flags, and loaded with `ctypes`. A rebuilt source gets a new file; an
unchanged one is reused. `build()` starts one `nvcc` per kernel, all at
once, and waits for all of them.

Nothing here runs at import: the CPU tests import every module, and
this machine needs no `nvcc` until a kernel is launched on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
#: every kernel the port builds; each is csrc/<name>.cu
KERNELS = ("paged_decode", "paged_prefill", "bitplane_gemv", "bitplane_gemm",
           "bitplane_pack", "bitplane_grouped")
#: the headers each kernel includes (part of its library's hash)
_HEADERS = {
    "paged_decode": ("paged_common.cuh", "tensor_core.cuh"),
    "paged_prefill": ("paged_common.cuh", "tensor_core.cuh"),
    "bitplane_gemv": ("bitplane_gemv_tile.cuh", "bitplane_common.cuh",
                      "tensor_core.cuh"),
    "bitplane_gemm": ("bitplane_common.cuh", "tensor_core.cuh"),
    "bitplane_pack": ("bitplane_common.cuh",),
    "bitplane_grouped": ("bitplane_gemv_tile.cuh", "bitplane_common.cuh",
                         "tensor_core.cuh"),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[str, object] = {}


def build_dir() -> Path:
    """`build/repro_torch_kernels/` at the root of the checkout."""
    return CSRC.parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built with the CUDA toolkit "
        "on the machine that has the card"
    )


def _sources(name: str):
    return [CSRC / f"{name}.cu"] + [CSRC / h for h in _HEADERS[name]]


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output of the last build (ptxas register and
    shared-memory report included)."""
    return lib_path(name).with_suffix(".log")


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library in `names` that is not built yet, one
    `nvcc` each, all started together; raise with the compiler's output
    if any build fails. Returns name -> library path."""
    names = list(names)
    jobs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(log_path(name), "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, out, log,
                     subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, out, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (rc {rc}):\n{log_path(name).read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: lib_path(name) for name in names}


def load_function(name: str, symbol: str, argtypes):
    """The C entry `symbol` of kernel library `name`, built at first
    use, with its `argtypes` declared and an int (cudaError_t) result."""
    fn = _FUNCTIONS.get(symbol)
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[symbol] = fn
    return fn
