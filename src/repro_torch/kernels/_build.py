"""Build the CUDA kernels at first use and bind them with ctypes.

The sources in ``csrc/`` (``attention.cu`` and ``scan.cu``, sharing
``common.cuh``, ``planner.cu`` and ``physics.cu``) have a plain C interface
and include no PyTorch header.
``nvcc`` compiles each source to an object file, all of them at once in
parallel processes, and links the objects into one shared library, which
is loaded with ``ctypes`` and called with raw device pointers and
PyTorch's current stream.  (A binding through
``torch.utils.cpp_extension.load`` would compile PyTorch's headers as
well, on every fresh machine.)

The library goes to ``build/kernels/`` at the root of the source checkout
(listed in ``.gitignore``), named by a hash of the source and flags, so an
edited source rebuilds and an unchanged one loads the existing file.  The
port runs from the source tree (``PYTHONPATH=src``); it is not installed
as a package.  Nothing is compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "attention.cu", CSRC / "scan.cu", CSRC / "planner.cu",
           CSRC / "physics.cu")
HEADERS = (CSRC / "common.cuh",)
ROOT = Path(__file__).resolve().parents[3]       # <root>/src/repro_torch/kernels
BUILD_DIR = ROOT / "build" / "kernels"
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=4")      # each nvcc optimises its kernels on 4 threads
# Flags of one source only.  The planner's float64 grant loop and the
# simulator's latency tables must round as numpy does: no a*b + c
# contracted into one fused multiply-add.
SOURCE_FLAGS = {"planner.cu": ("--fmad=false",), "physics.cu": ("--fmad=false",)}

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of the build (or load) that ran
ptxas_log = ""            # registers / shared memory / spills per kernel


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def compile_command(src: Path, obj: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", "-o",
            str(obj), str(src)]


def link_command(objs, out: Path) -> list:
    return [nvcc_path(), "-gencode=arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(out), *map(str, objs)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(" ".join(SOURCE_FLAGS.get(src.name, ())).encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprokernels-{h.hexdigest()[:16]}.so"


def _bind(lib):
    vp, i32, i64p, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float
    lib.repro_flash_attention.argtypes = [
        i32, i32, vp, vp, vp, vp, i32, i32, i32, i32, i64p, i32, i32, f32, vp]
    lib.repro_flash_attention.restype = i32
    lib.repro_decode_attention.argtypes = [
        i32, i32, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i64p, i32, f32, vp]
    lib.repro_decode_attention.restype = i32
    lib.repro_decode_cluster_room.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.repro_decode_cluster_room.restype = i32
    lib.repro_rwkv6_scan.argtypes = [
        i32, i32, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i64p, vp]
    lib.repro_rwkv6_scan.restype = i32
    lib.repro_ssd_scan.argtypes = [
        i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i64p, vp]
    lib.repro_ssd_scan.restype = i32
    lib.repro_alloc_all.argtypes = [vp, vp, i32, i32, vp]
    lib.repro_alloc_all.restype = i32
    lib.repro_tables.argtypes = [vp, vp, i32, i32, vp]
    lib.repro_tables.restype = i32
    return lib


def _build(path: Path) -> str:
    """Compile every source at once (one nvcc each), then link them into
    ``path``; returns the compilers' output.  Raises if any step fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        procs = [subprocess.Popen(compile_command(src, obj), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, p.returncode, log)
                  for src, p, log in zip(SOURCES, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        lib = Path(tmp) / path.name
        proc = subprocess.run(link_command(objs, lib), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(lib, path)              # atomic: concurrent builds agree
    return "".join(logs)


def load():
    """Return the bound kernel library, building it first if needed."""
    global _lib, build_seconds, ptxas_log
    with _lock:
        if _lib is not None:
            return _lib
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise RuntimeError(f"repro_torch at {CSRC.parents[1]} is not inside a source "
                               "checkout; the kernels build into the checkout's "
                               "build/kernels (run with PYTHONPATH=src)")
        t0 = time.perf_counter()
        path = library_path()
        if not path.exists():
            ptxas_log = _build(path)
        _lib = _bind(ctypes.CDLL(str(path)))
        build_seconds = time.perf_counter() - t0
        return _lib


CUDA_ERROR_INVALID_VALUE = 1


def check(err: int, name: str):
    """Raise if a launch was refused (the C function returns cudaError_t).
    cudaErrorInvalidValue is how the C interface refuses a head_dim, state
    size, dtype or query-group size that it has no kernel for."""
    if err == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name}: no kernel for these inputs (head_dim, state "
                         "size, dtype or query heads per kv head; see the "
                         "dispatch in csrc/)")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def check_vector_aligned(name: str, t, dims):
    """The kernels read four elements at a time: the tensor must start on a
    4-element boundary and its strides along ``dims`` be multiples of 4."""
    if t.data_ptr() % (4 * t.element_size()) or any(t.stride(d) % 4 for d in dims):
        raise ValueError(f"{name}: tensor of strides {t.stride()} is not aligned "
                         "to 4 elements (make it contiguous)")


def strides_arg(*tensors_dims):
    """Pack (tensor, dims) pairs into the kernels' int64 stride array."""
    vals = [t.stride(d) for t, dims in tensors_dims for d in dims]
    return (ctypes.c_longlong * len(vals))(*vals)


def compare_build_times():
    """Wall seconds of this module's parallel build and of the same
    compiles run one after another and linked, each into a fresh
    directory.
    Run on a machine with nvcc: ``PYTHONPATH=src python -m
    repro_torch.kernels._build``."""
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _build(Path(tmp) / "parallel.so")
        times["parallel_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        objs = [Path(tmp) / f"serial-{src.stem}.o" for src in SOURCES]
        for src, obj in zip(SOURCES, objs):
            subprocess.run(compile_command(src, obj), check=True, capture_output=True)
        subprocess.run(link_command(objs, Path(tmp) / "serial.so"), check=True,
                       capture_output=True)
        times["serial_s"] = time.perf_counter() - t0
    return times


def measure_peaks() -> str:
    """Build and run ``csrc/peak.cu`` (not part of the library): the card's
    wgmma and mma.sync TF32 rates and its float32 FMA rate, as one JSON
    line.  Run on
    a machine with nvcc: ``PYTHONPATH=src python -m
    repro_torch.kernels._build --peaks``."""
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "peak"
        subprocess.run([nvcc_path(), "-O3", "-gencode=arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-o", str(exe), str(CSRC / "peak.cu")],
                       check=True, capture_output=True)
        return subprocess.run([str(exe)], check=True, capture_output=True,
                              text=True).stdout.strip()


if __name__ == "__main__":
    import json
    import sys
    print(measure_peaks() if "--peaks" in sys.argv[1:] else json.dumps(compare_build_times()))
