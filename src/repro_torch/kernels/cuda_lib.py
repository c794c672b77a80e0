"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in ``src/repro_torch/csrc/*.cu``, each behind a plain C
interface.  At first use :func:`library` compiles every source with
``nvcc`` for ``sm_90a`` (one process per source, all started together),
links them into one shared library under ``build/`` at the repository
root, and loads it with ``ctypes``.  The library name carries a hash of
the sources and flags, so an edited kernel never loads a stale build.
Nothing here runs at import time: this module imports on a host with no
CUDA toolkit, and a build or load failure raises
:class:`KernelBuildError`.

Each kernel wrapper calls :func:`count` once per launch; the counts let a
run show that its main path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v") + ARCH_FLAGS

# C signatures: name -> argument types (pointers and the stream are
# c_void_p: ctypes would otherwise pass Python ints as 32-bit ints).
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # logits, w, idx, vals, T, E, k, kk, stream
    "repro_topk_gating": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # w, idx, dw, dvals, dlogits, T, E, k, kk, stream
    "repro_topk_gating_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, eidx, pos, scale, buf, T, k, d, E, C, dtype, stream
    "repro_dispatch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # buf, w, eidx, pos, y, T, k, d, E, C, in_dtype, out_dtype, stream
    "repro_combine": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, btok, bscale, buf, d, E, C, e_block, dtype, stream
    "repro_dispatch_eblock": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # buf, w, eidx, pos, y, T, k, d, E, C, e_block, in_dtype, out_dtype,
    # stream
    "repro_combine_eblock": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P),
    # x, w, out, rows, E, C, K, N, activation, dtype, trans_x, trans_w,
    # kernel, stream
    "repro_gmm": (_P, _P, _P, _P) + (_I,) * 9 + (_P,),
    # decode, T_in, k_in, d_in, d_out, f, E, C, mode, activation, dtype,
    # out bytes (a query: no stream)
    "repro_fused_workspace_bytes": (_I,) * 11 + (_P,),
    # x, valid, wg, w1, w2, w3, y, load, overflow, ws, T, d, E, f, k, C,
    # activation, dtype, stream
    "repro_fused_decode": (_P,) * 10 + (_I,) * 8 + (_P,),
    # x, in_e, in_p, out_e, out_p, out_w, w1, w2, w3, y, ws, T_in, k_in,
    # T_out, k_out, d_in, d_out, f, E, C, mode, activation, in_dtype,
    # out_dtype, stream
    "repro_fused_routed": (_P,) * 11 + (_I,) * 13 + (_P,),
}

# Element-type codes shared with csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class KernelBuildError(RuntimeError):
    """nvcc missing, a source failed to compile, or the library failed
    to load."""


class KernelLaunchError(RuntimeError):
    """A kernel refused its inputs or its launch failed."""


_launches: collections.Counter = collections.Counter()
_state: dict = {}


def count(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise KernelBuildError(
            "no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH); "
            "the port's kernels are built with nvcc at first use")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise KernelBuildError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path) -> str:
    """Compile every source in parallel, link, and return the compiler's
    messages (ptxas register / spill reports)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise KernelBuildError(
                f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib_path.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
               *[str(obj) for _, obj, _ in procs]]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise KernelBuildError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, lib_path)
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = _state.get("lib")
    if lib is not None:
        return lib
    lib_path = BUILD_DIR / f"librepro_torch_kernels-{_tag()}.so"
    t0 = time.perf_counter()
    log = ""
    if not lib_path.exists():
        log = _build(lib_path)
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as err:
        raise KernelBuildError(f"cannot load {lib_path}: {err}") from err
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _state.update(lib=lib, build_seconds=time.perf_counter() - t0,
                  build_log=log, path=lib_path)
    return lib


def build_info() -> dict:
    """Seconds the first :func:`library` call took (build + load), the
    compiler's messages (empty when a cached build was loaded) and the
    library path."""
    library()
    return {k: _state[k] for k in ("build_seconds", "build_log", "path")}


def call(name: str, *args) -> None:
    """Launch ``name`` on the current stream; raise on a non-zero
    ``cudaGetLastError()`` code."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, name)(*args, stream)
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise KernelLaunchError(f"{name} failed: CUDA error {code} ({msg})")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
