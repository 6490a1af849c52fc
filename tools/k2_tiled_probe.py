"""Probe builds of K2's tiled f32 kernel, timed in turns on the card.

Each variant is a patched copy of ``csrc/flash_attention.cu`` (its bf16
instances left out, so that each builds in seconds), built together with the
others by one ``nvcc`` each. A variant that computes the same function is
first held against K2's plain version; a removal probe (a part cut out) is
timed only. Times are device ms from CUDA-graph replay at the f32 legs'
causal shapes, the variants in turns, then in reverse::

    python3 -m tools.k2_tiled_probe [variant ...]

from the root of the repo. Variants: ``kernel`` (the source as it is),
``expf`` (exponentials by ``expf`` in place of ``exp_sfu``), ``approx``
(``exp_sfu`` without its correction: the special-function unit's ``ex2``
of x·log2 e rounded, up to |x|·2^-24 relative off ``exp``), and the removal
probes ``no_softmax`` (p = s, no max, sum or exponential), ``s_only`` (no
P·V) and ``pv_only`` (one 4-column chunk of the S product).
"""

from __future__ import annotations

import os
import re
import shutil
import statistics
import sys

import torch

from keystone_tpu_torch.core.kernels import BUILD_DIR, CSRC_DIR, Kernel, build_all
from keystone_tpu_torch.ops import flash_attention as fa

F32_PEAK_OPS = 6.7e13  # H100 SXM datasheet, f32 on CUDA cores
SHAPES = [(8, 16, 2048, 64), (8, 4, 2048, 64), (8, 8, 256, 32)]

_SOFTMAX_CALL = """      if (mask) {
        softmax_tile<DT, true>(s, m, lp, o, prow, pswz, tx, qi0, key0 + K * tx, s_k, causal,
                               q_offset, k_offset);
      } else {
        softmax_tile<DT, false>(s, m, lp, o, prow, pswz, tx, qi0, key0 + K * tx, s_k, causal,
                                q_offset, k_offset);
      }"""
_P_IS_S = """      for (int i = 0; i < R; ++i) {
        for (int h = 0; h < K; h += 4)
          *reinterpret_cast<float4*>(prow + C::kRPW * i * kBK + ((K * tx + h) ^ pswz)) =
              make_float4(s[i][h], s[i][h + 1], s[i][h + 2], s[i][h + 3]);
      }"""

# name: (source patches, whether it computes K2's function)
VARIANTS = {
    "kernel": ([], True),
    "expf": ([("  return fmaf(y, c, y);", "  return expf(x);")], True),
    "approx": ([("  return fmaf(y, c, y);", "  return y;")], True),
    "no_softmax": ([(_SOFTMAX_CALL, _P_IS_S)], False),
    "s_only": ([("      for (int j4 = 0; j4 < kBK; j4 += 4) {",
                 "      for (int j4 = 0; j4 < 0; j4 += 4) {")], False),
    "pv_only": ([("      for (int c = 0; c < nch; ++c) {",
                  "      for (int c = 0; c < 1; ++c) {")], False),
}


def variant_source(patches) -> str:
    """flash_attention.cu with its bf16 launches cut out and ``patches``
    applied; each patch must match once."""
    with open(os.path.join(CSRC_DIR, "flash_attention.cu")) as f:
        src = f.read()
    src = re.sub(r"  if \(in_dtype == 1 && out_dtype == [01]\) \{.*?\n  \}\n", "", src, flags=re.S)
    src = re.sub(r"(keystone_flash_attention_smem_bytes\(int d_in\) \{\n).*?\n\}",
                 r"\1  return 0;\n}", src, flags=re.S)
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"patch anchor not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names) -> dict:
    """One Kernel a variant, built together."""
    kernels = {}
    for name in names:
        d = os.path.join(BUILD_DIR, "probes", name)
        os.makedirs(d, exist_ok=True)
        for header in ("attention_sm90.cuh", "sm90_common.cuh"):
            shutil.copy(os.path.join(CSRC_DIR, header), d)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(variant_source(VARIANTS[name][0]))
        kernels[name] = Kernel(f"probe_{name}", os.path.join(d, "flash_attention.cu"))
    build_all(list(kernels.values()))
    return kernels


def graph_ms(fn, reps: int = 5, rounds: int = 3) -> float:
    """Device ms a call: ``reps`` calls in one CUDA graph, replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def agrees(kernel, device) -> bool:
    """The variant against K2's plain version at ragged shapes, f32 1e-5."""
    fa.FLASH_ATTENTION = kernel
    gen = torch.Generator(device=device).manual_seed(1)
    for (b, h, s_q, s_k, d), causal, q_off, k_off in (((2, 2, 130, 200, 64), True, 5, 90),
                                                     ((1, 3, 333, 129, 128), False, 0, 0),
                                                     ((3, 2, 97, 97, 33), True, 0, 0),
                                                     ((2, 2, 300, 700, 32), True, 3, 1)):
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=device)
                   for s in (s_q, s_k, s_k))
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off, return_lse=True)
        out, lse = fa.flash_attention(q, k, v, **kw)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        err = float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        if err > 1e-5 or float((lse - ref_lse).abs().max()) > 1e-4:
            return False
    return True


def main(argv) -> None:
    if not torch.cuda.is_available():
        sys.exit("k2_tiled_probe: CUDA is not available")
    names = argv or list(VARIANTS)
    device = torch.device("cuda:0")
    kernels = build(names)
    for name in names:
        if VARIANTS[name][1] and not agrees(kernels[name], device):
            sys.exit(f"k2_tiled_probe: {name} disagrees with K2's plain version")
    gen = torch.Generator(device=device).manual_seed(2)
    inputs = [tuple(torch.randn((b, h, s, d), generator=gen, device=device) for _ in range(3))
              for b, h, s, d in SHAPES]
    times = {name: {shape: [] for shape in SHAPES} for name in names}
    for order in (names, names[::-1]):
        for name in order:
            fa.FLASH_ATTENTION = kernels[name]
            for shape, (q, k, v) in zip(SHAPES, inputs):
                times[name][shape].append(
                    graph_ms(lambda: fa.flash_attention(q, k, v, causal=True)))
    print(torch.cuda.get_device_name(0))
    for shape in SHAPES:
        b, h, s, d = shape
        bound = 1e3 * 4.0 * b * h * d * s * (s + 1) / 2 / F32_PEAK_OPS
        print(f"{shape} causal, bound {bound:.4f} ms (operations)")
        for name in names:
            t = times[name][shape]
            print(f"  {name:>12}: {' '.join(f'{x:.4f}' for x in t)} ms "
                  f"({bound / min(t):.1%} of the bound)")


if __name__ == "__main__":
    main(sys.argv[1:])
