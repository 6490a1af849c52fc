"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). Copied from the
port's planner table (``plan/costs.DEVICE_PEAKS``: bf16 and HBM) with the
int8 and float32 rates added, so that no change to the program moves the
yardstick. A share of a peak is stated with the card's power limit
beside it (``device.power_limit_w`` in the run's stderr)."""

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS, "int8": INT8_OPS,
              "tf32": TF32_FLOPS, "float32": F32_FLOPS}


def bound_s(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time the card could take for ``ops`` operations in
    ``dtype`` and ``nbytes`` bytes moved, and which of the two bounds it."""
    t_ops = ops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
