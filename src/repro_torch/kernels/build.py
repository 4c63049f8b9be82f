"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` source (``ita_attention/csrc/{onepass,decode,
twopass}.cu``, ``ita_softmax/csrc/softmax.cu``, ``int8_matmul/csrc/
matmul.cu``) compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/repro_torch_kernels/lib<name>-<hash>.so

at first use, all sources at once in parallel processes. The file name
carries a hash of the source, every ``csrc/*.cuh`` header of the package
and the flags, so an edited source or header rebuilds and a built
library is reused. The build directory is ``build/
repro_torch_kernels/`` under the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_ATT = _PKG / "ita_attention" / "csrc"
# library name -> source
SOURCES = {
    "ita_onepass": _ATT / "onepass.cu",
    "ita_decode": _ATT / "decode.cu",
    "ita_twopass": _ATT / "twopass.cu",
    "ita_softmax": _PKG / "ita_softmax" / "csrc" / "softmax.cu",
    "int8_matmul": _PKG / "int8_matmul" / "csrc" / "matmul.cu",
}
# headers a source may include, from any kernel's csrc/ directory
HEADERS = tuple(sorted(_PKG.glob("*/csrc/*.cuh")))
# Ring launchers: q, k, v, lmult, omult, meta, out; bh, sq, skv, d, bkv,
# kv_4d, kv_rep, hq, g, causal, window, adaptive; the block geometry (row
# groups, warps per group, stages; decode also the cluster size); stream.
ONEPASS_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 \
    + [ctypes.c_void_p]
DECODE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 16 \
    + [ctypes.c_void_p]
# Paged launchers: q, k_pool, v_pool, page_table, lmult, omult, meta, out;
# bh, sq, n_pages, page, d, kv_rep, hq, g, causal, window, adaptive; the
# geometry as above; stream.
ONEPASS_PAGED_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 \
    + [ctypes.c_void_p]
DECODE_PAGED_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 \
    + [ctypes.c_void_p]
# Twopass pass 1: q, k, lmult, meta, a, row_max, inv, e_r; bh, sq, skv, d,
# bkv, kv_rep, causal, window, adaptive; the geometry (warps of 16 packed
# rows, stages); stream.
TWOPASS_QK_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 \
    + [ctypes.c_void_p]
# Twopass pass 2: a, row_max, inv, e_r, v, omult, meta, out; bh, sq, skv,
# d, bkv, kv_rep, causal, window; the geometry as pass 1; stream.
TWOPASS_AV_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
    + [ctypes.c_void_p]
# Softmax: x, mask, out; r, c, bc, adaptive; stream.
SOFTMAX_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
# B7a: x, wt, bias, mult, out; m, n, ld, bn; stream.
MATMUL_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
# B7b: x, wt, bias, mult, psum, out; m, n, k, bk, range_rows, staged,
# double_w; stream.
MATMUL_WS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]
# exported launcher -> (library, argtypes)
FUNCTIONS = {
    "ita_onepass_launch": ("ita_onepass", ONEPASS_ARGTYPES),
    "ita_onepass_paged_launch": ("ita_onepass", ONEPASS_PAGED_ARGTYPES),
    "ita_decode_launch": ("ita_decode", DECODE_ARGTYPES),
    "ita_decode_paged_launch": ("ita_decode", DECODE_PAGED_ARGTYPES),
    "ita_twopass_qk_launch": ("ita_twopass", TWOPASS_QK_ARGTYPES),
    "ita_twopass_av_launch": ("ita_twopass", TWOPASS_AV_ARGTYPES),
    "ita_softmax_launch": ("ita_softmax", SOFTMAX_ARGTYPES),
    "int8_matmul_launch": ("int8_matmul", MATMUL_ARGTYPES),
    "int8_matmul_ws_launch": ("int8_matmul", MATMUL_WS_ARGTYPES),
}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "CUDA kernels build on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (*HEADERS, SOURCES[name]):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> dict:
    """Compile every missing library, all nvcc processes started together.
    Returns ``{name: {"seconds": s, "log": ptxas output or ""}}`` for the
    libraries built by this call. ``verbose`` asks ptxas for each
    kernel's registers, shared memory and spills."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name, src in SOURCES.items():
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if missing), with the
    argument types of its launchers set."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn_name, (owner, argtypes) in FUNCTIONS.items():
            if owner == name:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def launcher(fn_name: str):
    """The exported launch function ``fn_name`` of its library."""
    return getattr(library(FUNCTIONS[fn_name][0]), fn_name)
