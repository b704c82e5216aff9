"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source under keisei_tpu_torch/csrc into one shared
library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/libkeisei_kernels.so csrc/*.cu

The library goes to `build/kernels-<hash>/` at the checkout's root (listed
in .gitignore), keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. Nothing here runs at
import time; a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libkeisei_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types; every one returns a cudaError_t as int
SIGNATURES = {
    "keisei_conv3x3_hwbc": [_P, _P, _P, _I, _I, _I, _P],
    "keisei_fused_gpbias_block": [_P] * 13 + [_I, _I, _I, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if this source hash has no library yet) and load the kernels."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in _sources() if s.suffix == ".cu"]]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=CSRC)
        log = (f"$ {' '.join(cmd)}\n# {time.monotonic() - t0:.1f} s, rc {proc.returncode}\n"
               f"{proc.stdout}{proc.stderr}")
        (out_dir / "build.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.keisei_cuda_error_string.argtypes = [ctypes.c_int]
    lib.keisei_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.keisei_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
