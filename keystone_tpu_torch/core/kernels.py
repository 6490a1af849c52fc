"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library under
``keystone_tpu_torch/_build/`` and loaded with ``ctypes``. A build happens
at first use, keyed by the content hash of the source and of every
``csrc/*.cuh`` header it includes, so ``python3 chip_smoke.py`` in a fresh
checkout builds everything it runs and an edited header is never served
from a stale library. A build
failure raises; nothing falls back to a plain version.

:func:`build_all` starts one ``nvcc`` per source together, so the build
time of several kernels is the slowest one's, not their sum.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)


def source_files(source: str) -> list[str]:
    """``source`` and every header it includes with ``#include "x.cuh"``,
    transitively, each resolved beside the file that includes it."""
    files, todo = [], [os.path.abspath(source)]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            text = f.read()
        base = os.path.dirname(path)
        todo.extend(os.path.join(base, name.decode()) for name in _INCLUDE.findall(text))
    return files


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


#: every Kernel made in this process (a module's kernels register when it
#: is imported); a server reports their launch counts in its health
KERNELS: list["Kernel"] = []


class Kernel:
    """One CUDA source, its built library, and its launch count.

    ``launches`` is a plain integer that the kernel's wrapper bumps once
    per launch; a run reads it to show its path went through the kernel.
    ``ptxas_info`` holds the compiler's register/shared-memory report.
    """

    def __init__(self, name: str, source: str):
        KERNELS.append(self)
        self.name = name
        self.source = os.path.join(CSRC_DIR, source)
        self.launches = 0
        self.ptxas_info = ""
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        self._functions: dict[str, ctypes._CFuncPtr] = {}

    def _target(self) -> str:
        h = hashlib.sha256()
        for path in source_files(self.source):
            with open(path, "rb") as f:
                h.update(os.path.basename(path).encode() + b"\0" + f.read())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:16]}.so")

    def _compile(self) -> tuple[subprocess.Popen, str, str] | None:
        """Start ``nvcc`` for this source unless its library is built;
        returns ``(process, temp output, target)`` for :meth:`_finish`.
        The library is written to a temp name and renamed into place, so
        a half-written file is never loaded."""
        target = self._target()
        if os.path.exists(target):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp, target

    def _finish(self, build: tuple[subprocess.Popen, str, str] | None) -> None:
        if build is None:
            return
        proc, tmp, target = build
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {self.source} (exit {proc.returncode}):\n{out}"
            )
        self.ptxas_info = out
        os.replace(tmp, target)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, building it first if needed."""
        with self._lock:
            if self._lib is None:
                self._finish(self._compile())
                self._lib = ctypes.CDLL(self._target())
            return self._lib

    def function(self, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
        """The library's C function ``symbol``, returning an int error
        code, with its argument types set; looked up once, since a
        wrapper on the decode path calls it thousands of times."""
        fn = self._functions.get(symbol)
        if fn is None:
            fn = getattr(self.lib(), symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            self._functions[symbol] = fn
        return fn


def launch_on(device, launch) -> int:
    """Call ``launch(stream)`` with ``device`` current and its current
    stream's handle; returns ``launch``'s error code. The device is
    switched only when it is not current already."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        return launch(stream)
    with torch.cuda.device(index):
        return launch(stream)


def build_all(kernels: list[Kernel]) -> None:
    """Build every kernel's library, all ``nvcc`` processes at once."""
    builds = [(k, k._compile()) for k in kernels]
    for k, build in builds:
        k._finish(build)
    for k in kernels:
        k.lib()


def check_launch(kernel: Kernel, code: int) -> None:
    """Raise on a nonzero ``cudaGetLastError`` code returned by a launch."""
    if code != 0:
        lib = kernel.lib()
        lib.keystone_cuda_error_string.restype = ctypes.c_char_p
        lib.keystone_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.keystone_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel.name} launch failed: {msg} ({code})")


# Operation counts for the cost profiles (observe/cost.py). A hand kernel
# is a ctypes launch that torch's FLOP counter never sees, and its plain
# version is torch ops that it would count differently, so each wrapper
# reports its kernel's own count through :func:`note_ops`, on either
# device, and runs its plain version outside the counter.
_counting = threading.local()


@contextlib.contextmanager
def count_ops():
    """Collect the operation counts the kernel wrappers report inside the
    scope (this thread); yields a one-element list holding the sum."""
    stack = getattr(_counting, "stack", None)
    if stack is None:
        stack = _counting.stack = []
    total = [0.0]
    stack.append(total)
    try:
        yield total
    finally:
        stack.pop()


def counting() -> bool:
    """True inside :func:`count_ops` on this thread: a wrapper computes
    its count only then."""
    return bool(getattr(_counting, "stack", None))


def note_ops(ops: float) -> None:
    """A wrapper's report of its kernel's operations for this call; a
    no-op outside :func:`count_ops`."""
    stack = getattr(_counting, "stack", None)
    if stack:
        stack[-1][0] += float(ops)


def attention_ops(b: int, h: int, s_q: int, s_k: int, d: int, *, causal: bool,
                  q_offset: int = 0, k_offset: int = 0) -> float:
    """Operations of one attention pass: 4·D (the two products) for each
    (query, key) pair it scores, the begin-aligned causal mask's visible
    pairs only."""
    if causal:
        import numpy as np

        seen = np.clip(np.arange(s_q) + (q_offset - k_offset + 1), 0, s_k)
        pairs = float(seen.sum())
    else:
        pairs = float(s_q) * s_k
    return 4.0 * b * h * d * pairs


def uncounted():
    """The scope a wrapper runs its plain version in: outside any torch
    dispatch mode (the FLOP counter) while :func:`count_ops` is open, so
    the kernel's reported count is the node's only count; a null context
    otherwise."""
    if not counting():
        return contextlib.nullcontext()
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()
