"""Build the CUDA kernels with nvcc on first use, bind them with ctypes,
and launch them.

Each ``csrc/<name>.cu`` exports plain C functions (no PyTorch headers, so a
build takes seconds, not minutes). It is compiled for ``sm_90a`` into its
own shared library under ``paddle_tpu_torch/_build/``, named by a
fingerprint of its source, the headers beside it (``csrc/*.cuh``) and the
compiler flags, so an edited source or header is rebuilt and an unchanged one is loaded as it is. :func:`build` starts one
``nvcc`` for each missing library, all at once, and waits for them.

A missing ``nvcc`` or a failed build raises :class:`KernelBuildError` with
the compiler's output; nothing falls back to the plain PyTorch version.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops.kernels import registry

__all__ = ["KernelBuildError", "KernelLaunchError", "SOURCES", "NVCC_FLAGS",
           "build", "load", "launch", "check_launch", "require_cuda",
           "source_path"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "_build")

#: kernel library name -> its source under csrc/
SOURCES = {
    "layer_norm": "layer_norm.cu",
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "fused_adam": "fused_adam.cu",
    "embedding": "embedding.cu",
    "fused_matmul": "fused_matmul.cu",
    "fused_sgd": "fused_sgd.cu",
    "softmax_xent": "softmax_xent.cu",
}

#: ``-Xptxas -v`` makes ptxas report registers, shared memory and spills
#: per kernel; the report is kept in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}


class KernelBuildError(EnforceNotMet):
    """nvcc is missing, or it failed to build a kernel library."""


def source_path(name):
    return os.path.join(_CSRC, SOURCES[name])


def _nvcc():
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of paddle_tpu_torch are "
        "built from source on first use and need the CUDA toolkit")


def _lib_path(name):
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(_CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names=None):
    """Build the named kernel libraries (default: all) that are not built
    yet, one nvcc process each, all started together. Returns
    ``{name: {"path", "seconds", "log"}}``; ``seconds`` is 0.0 and ``log``
    empty for a library that was already built."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        return _build_locked(names)


def _build_locked(names):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = {}
    procs = {}
    for name in names:
        so = _lib_path(name)
        if os.path.exists(so):
            out[name] = {"path": so, "seconds": 0.0, "log": ""}
            continue
        # per-process tmp name: concurrent build processes must not
        # interleave
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (so, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (so, tmp, t0, p) in procs.items():
        log, _ = p.communicate()
        secs = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"nvcc failed ({p.returncode}) for "
                          f"{SOURCES[name]}:\n{log[-4000:]}")
            continue
        os.replace(tmp, so)
        with open(so[:-3] + ".log", "w") as f:
            f.write(log)
        out[name] = {"path": so, "seconds": secs, "log": log}
    if failed:
        raise KernelBuildError("\n".join(failed))
    return out


def load(name, signatures):
    """The ctypes library of kernel ``name``, built first if needed, with
    ``signatures`` ({C function: argtypes, returning int, or (argtypes,
    restype)}) and ``pt_cuda_error_string`` declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _build_locked([name])[name]["path"]
            lib = ctypes.CDLL(path)
            for fn, sig in signatures.items():
                argtypes, restype = (sig if isinstance(sig, tuple)
                                     else (sig, ctypes.c_int))
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.pt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


class KernelLaunchError(EnforceNotMet):
    """CUDA refused a kernel launch."""


def check_launch(lib, kernel_name, err):
    """Raise :class:`KernelLaunchError` unless the launch returned 0."""
    if err != 0:
        msg = lib.pt_cuda_error_string(err).decode()
        raise KernelLaunchError(
            f"{kernel_name}: kernel launch failed with CUDA error {err} "
            f"({msg})")


def launch(lib, fn, name, device, *args, count=True):
    """Call ``fn`` of ``lib`` with ``args`` and the current stream of
    ``device`` (every launching C function takes the stream last); raise
    unless CUDA accepted the launch; with ``count``, count one launch of
    kernel ``name``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    check_launch(lib, name, err)
    if count:
        registry.get_kernel(name).count_launch()


def require_cuda(name, what, t):
    """Raise unless tensor ``t`` (named ``what``) is on a CUDA device."""
    if t.device.type != "cuda":
        raise EnforceNotMet(f"{name}: the kernel takes CUDA tensors, got "
                            f"{what} on {t.device}")
