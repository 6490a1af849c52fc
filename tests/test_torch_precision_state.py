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

import numpy as np
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


_LOWERED_ONEDNN = """
import sys
import numpy as np
import torch
from keystone_tpu_torch import convert
rng = np.random.default_rng(102)
rng.normal(size=(3, 32, 32, 3))
x = rng.uniform(0, 255, size=(3, 32, 32, 3)).astype(np.float32)
filters = rng.normal(size=(64, 108)).astype(np.float32)
means = rng.normal(size=(108,)).astype(np.float32)
out = convert.convolver(filters, means, device="cpu", patch_size=6)(torch.from_numpy(x))
np.savez(sys.argv[1], x=x, filters=filters, means=means, out=out.numpy())
"""


@pytest.mark.parametrize("mode", ["BF16", "ANY"])
def test_full_f32_scope_holds_under_lowered_onednn_default(tmp_path, mode):
    """oneDNN reads its default float32 math mode from the environment
    once a process, and torch's ``ieee`` flags leave that default in
    place: under ``ONEDNN_DEFAULT_FPMATH_MODE=BF16`` the Convolver's
    convolution at pixel scale read 4.0e-3 of max from float64 inside the
    full-f32 scope. In a fresh process with that state, the random-patch
    workload's case holds 1e-5 of max against float64."""
    from tests.test_torch_conv import TOL, _f64_convolver, _rel

    out = tmp_path / "conv.npz"
    env = dict(os.environ, ONEDNN_DEFAULT_FPMATH_MODE=mode)
    env.pop("KEYSTONE_MATMUL_PRECISION", None)
    run = subprocess.run([sys.executable, "-c", _LOWERED_ONEDNN, str(out)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    z = np.load(out)
    exact = _f64_convolver(z["x"], z["filters"], z["means"], 6, True)
    assert _rel(z["out"], exact) <= TOL
