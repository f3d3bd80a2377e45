"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``lib<name>-<hash>.so``
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so csrc/<name>.cu \
         -lcuda

``-lcuda`` links the driver API (``pwconv``'s TMA maps are encoded with
``cuTensorMapEncodeTiled``); nvcc finds the toolkit's stub at build time and
the driver's ``libcuda.so.1`` is loaded at run time.

The hash covers the source, every header of ``csrc/`` and the flags, so an
edited source never loads a stale library.  Builds happen at first launch, never
at import, into ``build/repro_torch/`` at the root of the checkout (listed
in ``.gitignore``); ``ptxas``'s register and shared-memory report lands
beside each library as ``lib<name>-<hash>.log``.  :func:`build` starts one
nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("dwconv2d", "pwconv", "separable_fused", "separable_fused_bf16",
           "separable_fused_f16", "fused_mbconv", "dw_se", "dwconv1d")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Libraries, after the source on nvcc's command line.
LINK_FLAGS = ("-lcuda",)

#: Element-type codes of ``csrc/common.cuh`` (``repro::DType``).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: (stream, store) dtype pairs the kernels are compiled for.
IO_PAIRS = frozenset({
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float16, torch.float16),
    (torch.float16, torch.float32)})

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, else the one on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns ``{name: path}``;
    raises RuntimeError with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, p in paths.items():
        if p.exists():
            continue
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu"),
             *LINK_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
        else:
            os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


class KernelLaunchError(RuntimeError):
    """A launch function returned a CUDA error code: ``code`` is the
    runtime's ``cudaError_t``, ``kernel`` the library's name.  Whether the
    runtime ladder may degrade around it is decided from the code alone
    (``runtime/failures.classify``)."""

    def __init__(self, message: str, *, kernel: str, code: int):
        super().__init__(message)
        self.kernel = kernel
        self.code = int(code)


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise :class:`KernelLaunchError` if a launch function returned a
    CUDA error code."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise KernelLaunchError(f"{name} kernel launch failed: CUDA error "
                                f"{code} ({msg})", kernel=name, code=code)


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, or NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def dtype_codes(in_dtype: torch.dtype, out_dtype: torch.dtype):
    """The kernels' codes for a (stream, store) pair; raises on a pair the
    kernels are not compiled for."""
    if (in_dtype, out_dtype) not in IO_PAIRS:
        raise ValueError(f"no kernel for stream {in_dtype} -> store "
                         f"{out_dtype}")
    return DTYPE_CODES[in_dtype], DTYPE_CODES[out_dtype]


def require_cuda(name: str, *tensors) -> torch.device:
    """The common device of ``tensors`` (None entries skipped), which must
    be a CUDA device; each tensor must be contiguous."""
    ts = [t for t in tensors if t is not None]
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    return dev
