"""ctypes bindings for the host C++ kernels — port of
``keystone_tpu/native/__init__.py``.

The IO and dense-SIFT library is built from the repository's
``native/fastio.cpp`` and ``native/dsift.cpp`` (read, never written) by
``g++ -O3 -fPIC -fopenmp -std=c++17`` at first use, into
``keystone_tpu_torch/_build/``, keyed by the sources' content hash and
written under a temp name then renamed, as :mod:`keystone_tpu_torch.core.
kernels` builds the CUDA kernels. Nothing here runs ``make`` or touches a
library under ``native/``. A compiler without OpenMP's runtime (no
``libgomp``) builds the same sources serially: the pragmas are ignored,
an empty ``omp.h`` stands in for the missing header, and the loops give
the same results on one thread (logged; :attr:`HostLibrary.openmp` says
which build loaded).

:func:`get_lib` returns ``None`` when the library cannot be built or
loaded (logged), so the loaders fall back to numpy; :func:`require_lib`
raises instead, for callers that asked for the native path by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from keystone_tpu_torch.core.kernels import BUILD_DIR, PACKAGE_DIR
from keystone_tpu_torch.core.logging import get_logger

logger = get_logger("keystone_tpu_torch.native")

#: the repository's C++ sources, shared with the JAX package
NATIVE_DIR = os.path.abspath(os.path.join(PACKAGE_DIR, "..", "native"))
IO_SOURCES = ("fastio.cpp", "dsift.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
OPENMP_FLAGS = ["-fopenmp"]


class HostLibrary:
    """One host shared library built by ``g++`` from C++ sources, loaded
    with ctypes; ``bind`` sets the argument and return types of its
    entry points once, after the load."""

    def __init__(self, name: str, sources: list[str], bind):
        self.name = name
        self.sources = sources
        self._bind = bind
        self._lib: ctypes.CDLL | None = None
        self._error: Exception | None = None
        self._lock = threading.Lock()
        #: whether the loaded library was built with OpenMP (None: not loaded)
        self.openmp: bool | None = None

    def _target(self, openmp: bool) -> str:
        h = hashlib.sha256()
        for path in self.sources:
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode() + b"\0" + f.read())
        kind = "" if openmp else "-serial"
        return os.path.join(BUILD_DIR, f"lib{self.name}{kind}-{h.hexdigest()[:16]}.so")

    def _compile(self, target: str, openmp: bool) -> None:
        """One ``g++`` build of the sources into ``target`` (a temp name,
        then a rename); raises with the compiler's output on failure."""
        os.makedirs(BUILD_DIR, exist_ok=True)
        flags = list(CXX_FLAGS)
        if openmp:
            flags += OPENMP_FLAGS
        else:
            stub = os.path.join(BUILD_DIR, "serial_include")
            os.makedirs(stub, exist_ok=True)
            with open(os.path.join(stub, "omp.h"), "w") as f:
                f.write("/* serial build: no OpenMP runtime */\n")
            flags += ["-Wno-unknown-pragmas", "-I", stub]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [os.environ.get("CXX", "g++"), *flags, "-o", tmp, *self.sources]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed for {self.name} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _load(self) -> ctypes.CDLL:
        """The OpenMP build, else (a compiler without OpenMP's runtime)
        the serial one."""
        try:
            target = self._target(openmp=True)
            if not os.path.exists(target):
                self._compile(target, openmp=True)
            openmp = True
        except RuntimeError as e:
            logger.warning("OpenMP build of %s failed; building it serially (%s)",
                           self.name, str(e).splitlines()[-1] if str(e) else e)
            target = self._target(openmp=False)
            if not os.path.exists(target):
                self._compile(target, openmp=False)
            openmp = False
        lib = ctypes.CDLL(target)
        self._bind(lib)
        self.openmp = openmp
        return lib

    def require(self) -> ctypes.CDLL:
        """The loaded library, built first if needed; raises when the
        build or the load fails (the failure is kept, not retried)."""
        with self._lock:
            if self._lib is None and self._error is None:
                try:
                    self._lib = self._load()
                except (OSError, RuntimeError, subprocess.SubprocessError, AttributeError) as e:
                    self._error = e
            if self._lib is None:
                raise RuntimeError(f"native library {self.name} is unavailable: {self._error}")
            return self._lib

    def get(self) -> ctypes.CDLL | None:
        """The loaded library, or None (logged) when it cannot be had."""
        try:
            return self.require()
        except RuntimeError as e:
            logger.info("%s; using the numpy fallback", e)
            return None


def _bind_io(lib: ctypes.CDLL) -> None:
    i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    lib.csv_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.csv_dims.restype = ctypes.c_int
    lib.csv_read.argtypes = [ctypes.c_char_p, f32p, i64, i64]
    lib.csv_read.restype = ctypes.c_int
    lib.cifar_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), f32p, i64]
    lib.cifar_read.restype = i64
    lib.dsift_descriptor_count.argtypes = [ctypes.c_int] * 6
    lib.dsift_descriptor_count.restype = ctypes.c_int
    lib.dsift_flat_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        *([ctypes.c_int] * 7),
        ctypes.POINTER(ctypes.c_int16),
    ]
    lib.dsift_flat_batch.restype = ctypes.c_int


IO_LIB = HostLibrary(
    "keystone_io", [os.path.join(NATIVE_DIR, s) for s in IO_SOURCES], _bind_io
)


def get_lib() -> ctypes.CDLL | None:
    """The IO and dense-SIFT library, built on first use; None (logged)
    when it cannot be built or loaded."""
    return IO_LIB.get()


def require_lib() -> ctypes.CDLL:
    """The IO and dense-SIFT library; raises when it cannot be had."""
    return IO_LIB.require()


def native_load_csv(path: str) -> np.ndarray | None:
    """Parse a float CSV with the native kernel; None → the caller falls
    back (no library, or a file the parser refuses, e.g. ragged rows)."""
    lib = get_lib()
    if lib is None:
        return None
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    if lib.csv_dims(path.encode(), ctypes.byref(rows), ctypes.byref(cols)):
        return None
    out = np.empty((rows.value, cols.value), np.float32)
    rc = lib.csv_read(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.value,
        cols.value,
    )
    if rc != 0:
        logger.info("native csv parse failed (rc=%d) for %s", rc, path)
        return None
    return out


def native_dsift(
    images: np.ndarray,
    *,
    step: int = 3,
    bin_size: int = 4,
    num_scales: int = 5,
    scale_step: int = 0,
) -> np.ndarray:
    """Host dense SIFT (``native/dsift.cpp``: the same flat-window
    algorithm and output layout as ``ops.sift.SIFTExtractor``).

    images: (N, H, W) grayscale in [0, 1] → (N, 128, M) float32. Raises
    when the library cannot be built or its count disagrees."""
    if step < 1 or bin_size < 1 or num_scales < 1:
        raise ValueError("dsift needs step >= 1, bin_size >= 1, num_scales >= 1")
    if any(step + s * scale_step < 1 for s in range(num_scales)):
        raise ValueError(f"scale_step={scale_step} drives the per-scale step below 1")
    lib = require_lib()
    images = np.ascontiguousarray(images, np.float32)
    n, h, w = images.shape
    count = lib.dsift_descriptor_count(h, w, step, bin_size, num_scales, scale_step)
    out = np.empty((n, count, 128), np.int16)
    got = lib.dsift_flat_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, h, w, step, bin_size, num_scales, scale_step,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    if got != count:
        raise RuntimeError(f"native dsift count mismatch: {got} != {count}")
    return np.transpose(out, (0, 2, 1)).astype(np.float32)


def native_load_cifar(path: str) -> tuple[np.ndarray, np.ndarray] | None:
    """Parse CIFAR-10 binary records natively → (labels, NHWC images);
    None → the caller falls back."""
    lib = get_lib()
    if lib is None:
        return None
    size = os.path.getsize(path)
    record = 1 + 3072
    if size % record:
        return None
    n = size // record
    labels = np.empty(n, np.int32)
    images = np.empty((n, 32, 32, 3), np.float32)
    got = lib.cifar_read(
        path.encode(),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
    )
    if got != n:
        return None
    return labels, images
