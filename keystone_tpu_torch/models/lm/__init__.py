"""Decoder-only transformer LM, serving and scoring surface — port of
``keystone_tpu/models/lm``:

- :mod:`.model` — TransformerLM / LMBlock;
- :mod:`.losses` — next-token CE, dense and logit-chunked (forward);
- :mod:`.train` — the synthetic corpus (training comes with the
  training slice);
- :mod:`.decode` — KV-cache serving: prefill, decode, sampling,
  weight-only int8 quantization.
"""

from keystone_tpu_torch.models.lm.decode import (
    KVCache,
    decode_step,
    generate,
    prefill,
    quantize_for_decode,
)
from keystone_tpu_torch.models.lm.losses import (
    chunked_token_cross_entropy,
    next_token_loss,
    token_cross_entropy,
)
from keystone_tpu_torch.models.lm.model import LMBlock, TransformerLM
from keystone_tpu_torch.models.lm.train import synthetic_corpus

__all__ = [
    "KVCache",
    "LMBlock",
    "TransformerLM",
    "chunked_token_cross_entropy",
    "decode_step",
    "generate",
    "next_token_loss",
    "prefill",
    "quantize_for_decode",
    "synthetic_corpus",
    "token_cross_entropy",
]
