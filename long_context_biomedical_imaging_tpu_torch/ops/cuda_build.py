"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each kernel source compiles at its first launch with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which loads with
``ctypes``. Nothing is built or imported while a module is imported, so the
CPU tests import every module on a machine without ``nvcc`` or a card.

Libraries go to ``build/kernels/`` at the repository root (listed in
``.gitignore``). The file name carries a hash of every ``csrc/`` file and of
the flags, so an edited source rebuilds; a build writes a temporary file and
renames it into place, so concurrent processes never load half a library.

A backward kernel sums its weight gradients over a parallel grid: each block
of a persistent grid accumulates into its own fp32 slot, and a second kernel
reduces the slots in a fixed order. :func:`slot_layout` packs the gradients
into a slot and :func:`slot_count` bounds the scratch.

Every C entry point returns ``cudaGetLastError()`` of its launch: a launch the
card refuses (too many threads, too much shared memory) never runs, and
``torch.cuda.synchronize()`` would not report it. :class:`CudaKernel` raises
on any non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the "
                       "CUDA kernels are built from csrc/ at first launch")


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_library(source: str) -> tuple[Path, str]:
    """Compile csrc/<source> unless its library exists; returns (path,
    compiler log). The log is empty when the library was already built."""
    stem = Path(source).stem
    out = BUILD_DIR / f"lib{stem}-{_sources_digest()}.so"
    if out.exists():
        return out, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


class CudaKernel:
    """One C entry point of a ``csrc/`` source, loaded on first use.

    ``launches`` counts the launches made through this object: it grows by
    one at each call, which is the one place the kernel is launched.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fn = None
        self._error_string = None

    def load(self) -> float:
        """Build (if needed) and load the library; returns the seconds spent."""
        if self._fn is not None:
            return 0.0
        t0 = time.perf_counter()
        path, self.build_log = build_library(self.source)
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.lcbi_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib, self._fn, self._error_string = lib, fn, err
        return time.perf_counter() - t0

    def query(self, symbol: str, argtypes: list, restype, *args):
        """Call another C function of the same library, one that launches
        nothing (a size query); not counted as a launch."""
        self.load()
        fn = getattr(self._lib, symbol)
        fn.argtypes, fn.restype = argtypes, restype
        return fn(*args)

    def __call__(self, *args) -> None:
        self.load()
        self.launches += 1
        code = self._fn(*args)
        if code != 0:
            msg = self._error_string(code).decode(errors="replace")
            raise RuntimeError(f"{self.symbol} failed: CUDA error {code} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> NULL) for a c_void_p argument."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_handle(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


SLOT_BYTES_BUDGET = 2 * 2**30


def slot_layout(sizes) -> tuple[dict, int]:
    """Offsets (in floats) of named gradients packed into one block's slot of
    a backward kernel, each starting on a multiple of 8 floats (32 bytes, what
    the WMMA fragment loads and stores take); returns (offsets, slot floats,
    a multiple of 8)."""
    offsets, at = {}, 0
    for name, count in sizes:
        offsets[name] = at
        at += (count + 7) // 8 * 8
    return offsets, at


def slot_count(slot_floats: int, device) -> int:
    """Slots to allocate for a persistent backward grid: four per SM at most
    (the kernel runs no more blocks than fit at once) and no more than
    SLOT_BYTES_BUDGET of fp32 scratch in all."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(4 * sms, SLOT_BYTES_BUDGET // (4 * slot_floats)))


def check_cuda_operand(name: str, t, device, dtype, shape) -> None:
    """Raise unless t is a contiguous, 32-byte-aligned tensor of the given
    device, dtype and shape: what the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 32:
        raise ValueError(f"{name} must be 32-byte aligned")
