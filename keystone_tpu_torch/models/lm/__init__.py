"""Decoder-only transformer LM, serving surface — port of
``keystone_tpu/models/lm``:

- :mod:`.model` — TransformerLM / LMBlock;
- :mod:`.decode` — KV-cache serving: prefill, decode, sampling,
  weight-only int8 quantization.

Losses and training come with the training slice.
"""

from keystone_tpu_torch.models.lm.decode import (
    KVCache,
    decode_step,
    generate,
    prefill,
    quantize_for_decode,
)
from keystone_tpu_torch.models.lm.model import LMBlock, TransformerLM

__all__ = [
    "KVCache",
    "LMBlock",
    "TransformerLM",
    "decode_step",
    "generate",
    "prefill",
    "quantize_for_decode",
]
