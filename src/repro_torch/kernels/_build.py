"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, one ``nvcc`` per source started together, into
``build/`` beside this file (listed in ``.gitignore``); the library's name
carries a hash of the sources and flags, so a changed source is rebuilt.
Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("flash_attention.cu", "decode_attention.cu", "paged_attention.cu",
           "ssd_diag.cu")
HEADERS = ("common.cuh", "decode_kernels.cuh", "flash_tiles.cuh", "split_kv.cuh",
           "tf32.cuh", "wgmma.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libreprokernels_{source_hash()}.so"


def build() -> tuple[Path, str]:
    """Compile the sources if the library for their hash is missing.

    Returns (library path, compiler log). The log holds ptxas's register,
    shared-memory and spill lines for every kernel; it is empty when the
    library was already built."""
    lib = library_path()
    if lib.is_file():
        return lib, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objs, failed = [], [], []
        for name, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            objs.append(str(obj))
            if p.returncode != 0:
                failed.append(name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged), *objs],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(staged, lib)   # atomic: a concurrent loader sees all or none
    return lib, log


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (pointers and the stream as
    ``c_void_p``, so none is cut to 32 bits)."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_int64)
    lib.repro_flash_attention.argtypes = [
        vp, vp, vp, vp, vp, strides, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        f32, i32, vp]
    lib.repro_flash_attention.restype = i32
    lib.repro_flash_selftest.argtypes = [vp, vp, vp, vp, vp, i32, vp]
    lib.repro_flash_selftest.restype = i32
    lib.repro_decode_attention.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, strides, i32, i32, i32, i32, i32, i32,
        i32, f32, i32, vp]
    lib.repro_decode_attention.restype = i32
    lib.repro_paged_attention.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, strides, i32, i32, i32, i32, i32, i32, i32,
        i32, f32, i32, vp]
    lib.repro_paged_attention.restype = i32
    lib.repro_ssd_workspace.argtypes = [i32, i32, i32, i32]
    lib.repro_ssd_workspace.restype = ctypes.c_int64
    lib.repro_ssd_diag.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.repro_ssd_diag.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed and load the kernels' library, once per process."""
    path, _ = build()
    return bind(ctypes.CDLL(str(path)))


def raw_stream(device) -> int:
    """The current CUDA stream of `device` as the integer the C entry points
    take, in one C++ call (`torch.cuda.current_stream` builds a Stream
    object through several Python calls every launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def int64_array(values) -> ctypes.Array:
    values = [int(x) for x in values]
    return (ctypes.c_int64 * len(values))(*values)
