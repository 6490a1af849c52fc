"""No port test file leaves float32 precision state behind for the next.

``test_torch_conv``'s adverse-state case sets torch's legacy matmul
precision to ``medium``; ``test_torch_flash``'s per-test fixture once read
that string back and wrote it again at teardown, which set oneDNN's
matmul to bf16 for the rest of the process, and the float32 products of
every later test in the same process ran in bf16 (the naive Bayes case
read 2.3e-3 of max against 1e-5). This runs the three in that order in
one fresh process, as one pytest worker does, and asserts that each
passes. No tolerance is loosened for it."""

import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEQUENCE = [
    "tests/test_torch_conv.py::test_full_f32_scope_holds_under_adverse_precision_state[mixed_apis]",
    "tests/test_torch_flash.py::test_flash_matches_jax_f32",
    "tests/test_torch_text.py::test_naive_bayes_matches_jax",
]


def test_precision_state_does_not_leak_across_test_files(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
           "-p", "no:xdist", f"--basetemp={tmp_path / 'run'}", *SEQUENCE]
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-2000:]
    assert " passed" in run.stdout and "failed" not in run.stdout, run.stdout[-2000:]
