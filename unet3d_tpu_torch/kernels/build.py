"""Build and load the port's CUDA kernels.

The sources under ``unet3d_tpu_torch/ops/kernels/`` are compiled by ``nvcc``
for ``sm_90a``, one process per source, all started together, and linked into
one shared library with a plain C interface, which is loaded with ``ctypes``.
No source includes PyTorch's headers, which keeps the build several times
shorter than a ``torch.utils.cpp_extension`` module's.

Errors: the C entry point returns the ``cudaError_t`` of the launch itself
(bad configuration, no kernel image for the card), and the wrapper raises on
it. A fault while the kernel runs is asynchronous and surfaces at the next
synchronising call, as with any CUDA kernel; there is no per-launch device
synchronisation.

The library goes to ``build/torch_ext/`` in the checkout (git ignores it),
named after a hash of the sources and flags, so a rebuilt checkout reuses it
and an edited source builds anew. Nothing is built when the package is
imported: the first kernel call builds, and ``load_library()`` may be called
ahead of it to time the build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
_KERNELS = _PACKAGE / "ops" / "kernels"
SOURCES = tuple(_KERNELS / name for name in (
    "conv3d.cu", "conv3d_wgmma.cu", "s2_wgrad.cu", "s2_wgrad_wgmma.cu", "winograd.cu"))
HEADERS = (_KERNELS / "sm90_wgmma.cuh",)  # included by the sources, hashed with them
BUILD_DIR = _PACKAGE.parent / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib = None
_lock = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` from CUDA_HOME, the default toolkit path, or PATH."""
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from source at first use")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libunet3d_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _wait(cmd, proc: subprocess.Popen) -> None:
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{output}")


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(SOURCES, objects)]
    procs = []
    try:
        procs.extend(_run(cmd) for cmd in cmds)
        for cmd, proc in zip(cmds, procs):
            _wait(cmd, proc)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        _wait(link, _run(link))
        os.replace(tmp, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objects:
            obj.unlink(missing_ok=True)


def _check_wgmma_configs(lib: ctypes.CDLL) -> None:
    """The C table of wgmma tile configurations is the wrapper's."""
    from unet3d_tpu_torch.ops.conv3d_kernel import WGMMA_CONFIGS

    out = (ctypes.c_int * 8)()
    table = []
    while lib.unet3d_conv3x3x3_wgmma_config(len(table), out) == 0:
        table.append(tuple(out))
    if tuple(table) != WGMMA_CONFIGS:
        raise RuntimeError(f"conv3d_wgmma.cu CONFIGS {table} differ from "
                           f"conv3d_kernel.WGMMA_CONFIGS {WGMMA_CONFIGS}")


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.unet3d_conv3x3x3_ndhwc.argtypes = [
                i, i, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
            lib.unet3d_conv3x3x3_ndhwc.restype = i
            lib.unet3d_conv3x3x3_wgmma.argtypes = [
                i, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i,
                ctypes.c_float, p]
            lib.unet3d_conv3x3x3_wgmma.restype = i
            lib.unet3d_conv3x3x3_wgmma_config.argtypes = [i, ctypes.POINTER(i)]
            lib.unet3d_conv3x3x3_wgmma_config.restype = i
            _check_wgmma_configs(lib)
            lib.unet3d_s2_wgrad_ndhwc.argtypes = [
                i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, ctypes.c_longlong, p]
            lib.unet3d_s2_wgrad_ndhwc.restype = i
            lib.unet3d_s2_wgrad_wgmma.argtypes = [
                i, i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i, i, i, i, p]
            lib.unet3d_s2_wgrad_wgmma.restype = i
            lib.unet3d_winograd3x3x3_ndhwc.argtypes = [
                i, i, p, p, p, p, i, i, i, i, i, i, i, i, p]
            lib.unet3d_winograd3x3x3_ndhwc.restype = i
            lib.unet3d_cuda_error_string.argtypes = [i]
            lib.unet3d_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
