"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source under keisei_tpu_torch/csrc to an object file,
one nvcc process per source, all started together, then links them into
one shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c csrc/<name>.cu -o <build>/<name>.o        (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <build>/libkeisei_kernels.so *.o -ldl

(-ldl: the wgmma kernels look libcuda's tensor-map encoder up with dlsym.)

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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-ldl"]
LIB_NAME = "libkeisei_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types; every one returns a cudaError_t as int
SIGNATURES = {
    "keisei_conv3x3_bpc": [_P, _P, _P, _I, _I, _I, _I, _P],
    "keisei_conv3x3_wgmma": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "keisei_fused_gpbias_block": [_P] * 16 + [_I] * 6 + [_P],
    "keisei_fused_block_stage": [_P] * 11 + [_I] * 6 + [_P],
    "keisei_quantized_gpbias_block": [_P] * 19 + [_I] * 7 + [_P],
    "keisei_qblock_part": [_I] + [_P] * 7 + [_I] * 4 + [_P],
    "keisei_tiled_mm": [_P, _P, _P, _I, _I, _I, _I, _P],
    "keisei_gemm_chain": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "keisei_gemm_chain_clusters": [_I, _I, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"


def _run_all(cmds: list[list[str]], log_dir: Path) -> list[tuple[list[str], int, str]]:
    """Run the commands concurrently, each writing to a file of its own
    (no pipe can fill); (cmd, returncode, output) of each."""
    runs = []
    for i, cmd in enumerate(cmds):
        out = open(log_dir / f"cmd{i}.{os.getpid()}.log", "w+")
        runs.append((cmd, subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, cwd=CSRC),
                     out))
    results = []
    for cmd, proc, out in runs:
        rc = proc.wait()
        with out:
            out.seek(0)
            results.append((cmd, rc, out.read()))
        os.unlink(out.name)
    return results


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if this source hash has no library yet) and load the kernels."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [out_dir / f"{s.stem}.{tag}.o" for s in srcs]
        t0 = time.monotonic()
        runs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                         for s, o in zip(srcs, objs)], out_dir)
        tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
        if all(rc == 0 for _, rc, _ in runs):
            runs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *[str(o) for o in objs], *LINK_FLAGS]], out_dir)
        log = "".join(f"$ {' '.join(cmd)}\n# rc {rc}\n{out}" for cmd, rc, out in runs)
        log += f"# {time.monotonic() - t0:.1f} s in all\n"
        (out_dir / "build.log").write_text(log)
        for o in objs:
            o.unlink(missing_ok=True)
        if any(rc != 0 for _, rc, _ in runs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.keisei_cuda_error_string.argtypes = [ctypes.c_int]
    lib.keisei_cuda_error_string.restype = ctypes.c_char_p
    return lib


# SASS instruction classes: warpgroup MMAs, mma.sync, TMA loads, local memory (spills)
SASS_CLASSES = {"wgmma": r"\b[HI]GMMA\.", "mma_sync": r"\b[HI]MMA\.", "tma_load": r"\bUTMALDG\b",
                "local": r"\b(STL|LDL)\b"}


def sass_counts(kernel_pattern: str) -> dict[str, dict[str, int]]:
    """Per kernel of the built library whose (mangled) name matches
    `kernel_pattern`: how many instructions of each SASS_CLASSES class its
    SASS holds (`cuobjdump -sass`). Raises if cuobjdump is missing."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found (PATH or /usr/local/cuda/bin)")
    load_library()
    sass = subprocess.run([tool, "-sass", str(build_dir() / LIB_NAME)], check=True,
                          capture_output=True, text=True).stdout
    counts: dict[str, dict[str, int]] = {}
    name = None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            if re.search(kernel_pattern, name):
                counts[name] = {k: 0 for k in SASS_CLASSES}
            continue
        if name in counts:
            for k, pattern in SASS_CLASSES.items():
                counts[name][k] += bool(re.search(pattern, line))
    return counts


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.keisei_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
