"""Build and load the port's CUDA kernels (``mccnn_tpu_torch/csrc/*.cu``).

At first use the sources are compiled with ``nvcc`` for Hopper
(``sm_90a``), one compiler process per source file, all started together,
and linked into one shared library with a plain C interface, which is
loaded with ``ctypes``. That takes seconds; an extension that includes
PyTorch's headers would take minutes to build. In a source checkout the
library lives in ``build/mccnn_tpu_torch/`` at the checkout root; an
installed copy of the package uses ``~/.cache/mccnn_tpu_torch/`` instead.
It is named by a hash of the sources and flags, so a source change
rebuilds it and an unchanged tree reuses it. ``build.log`` beside it keeps
the last compiler output (``-Xptxas -v``: registers, shared memory and
spills per kernel).

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` raises on anything but 0. Nothing here falls back to anything:
a missing compiler, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from mccnn_tpu_torch.utils import tracing

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
_CHECKOUT = Path(__file__).resolve().parents[2]
# a checkout has setup.py beside the package; site-packages does not
BUILD_DIR = (_CHECKOUT / "build" if (_CHECKOUT / "setup.py").exists()
             else Path.home() / ".cache") / "mccnn_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p (a plain int would
# be cut to 32 bits), every return a cudaError_t as int
_SIGNATURES = {
    "mccnn_band_side": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "mccnn_band_pair": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mccnn_band_scores": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "mccnn_cbca_round": (_P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _P),
    "mccnn_cbca_stencil_round": (_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _P),
    "mccnn_cbca_round_int8": (_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _P),
    "mccnn_cbca_rolling_round": (_P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _P),
    "mccnn_cbca_two_rounds": (_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _P),
    "mccnn_cbca_stream": (_P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _P),
    "mccnn_sgm_sweep": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _F, _F, _F, _F, _I, _P),
    "mccnn_border_fill": (_P, _I, _I, _I, _I, _I, _I, _P),
}


class LaunchCounts:
    """Launches per kernel; each wrapper adds one where it launches."""

    NAMES = ("band_side", "cbca_round", "sgm_sweep", "cbca_round_int8",
             "band_pair", "cbca_stencil_round", "band_scores",
             "cbca_rolling_round", "cbca_two_rounds", "cbca_stream",
             "border_fill")

    def __init__(self):
        self.counts = dict.fromkeys(self.NAMES, 0)

    def add(self, name: str) -> None:
        self.counts[name] += 1

    def reset(self) -> None:
        self.counts = dict.fromkeys(self.NAMES, 0)

    def snapshot(self) -> dict:
        return dict(self.counts)


LAUNCHES = LaunchCounts()


def nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built"
    )


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu")), sorted(SOURCE_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Path of the library for the current sources (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libmccnn_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless the current sources are built already.

    Returns the library path and the seconds spent compiling (0.0 when
    reused). The library is written to a temporary name and renamed, so
    concurrent builds never load a half-written file. The call is the set-up
    span ``setup.library``.
    """
    with tracing.setup_span("library"):
        return _build()


def _build() -> tuple[Path, float]:
    target = library_path()
    if target.exists():
        return target, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    compiler = nvcc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objects = [os.path.join(objdir, src.stem + ".o") for src in cu]
        commands = [[compiler, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(cu, objects)]
        compilers = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in commands]
        outputs = [proc.communicate()[0] for proc in compilers]
        failed = [proc.returncode for proc in compilers if proc.returncode]
        commands.append([compiler, *_ARCH, "-shared", "-o", tmp, *objects])
        if not failed:
            link = subprocess.run(commands[-1], capture_output=True, text=True)
            outputs.append(link.stdout + link.stderr)
            failed = [link.returncode] if link.returncode else []
    seconds = time.perf_counter() - t0
    log = "".join(" ".join(cmd) + "\n" + out
                  for cmd, out in zip(commands, outputs))
    (BUILD_DIR / "build.log").write_text(log)
    if failed:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log[-6000:]}")
    os.replace(tmp, target)
    return target, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call). Loading it is the
    set-up span ``setup.load``, after ``build``'s ``setup.library``."""
    path, _ = build()
    with tracing.setup_span("load"):
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.mccnn_error_string.argtypes = [ctypes.c_int]
        lib.mccnn_error_string.restype = ctypes.c_char_p
        return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        message = library().mccnn_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({message})")


def stream_handle(tensor: torch.Tensor) -> int:
    """The current CUDA stream of ``tensor``'s device, as an int handle."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda(name: str, tensor: torch.Tensor, dtypes) -> None:
    """Check a kernel operand: on CUDA, contiguous and of a supported type."""
    if tensor.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {tensor.device}")
    if tensor.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {tensor.dtype}, want {dtypes}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
