"""Decoder-only transformer LM: training, serving and scoring — port of
``keystone_tpu/models/lm``:

- :mod:`.model` — TransformerLM / LMBlock;
- :mod:`.losses` — next-token CE, dense and logit-chunked;
- :mod:`.train` — optax-exact AdamW, the train step, the
  pipeline-parallel step and the loop, the synthetic corpus;
- :mod:`.sharding` — ``shard_params``, the Megatron-style tensor-parallel
  layout, and its inverse;
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
from keystone_tpu_torch.models.lm.model import LMBlock, TransformerLM, train_step_flops
from keystone_tpu_torch.models.lm.sharding import shard_params, unshard_params
from keystone_tpu_torch.models.lm.train import (
    make_optimizer,
    make_pp_train_step,
    make_train_step,
    next_token_loss_pp,
    pp_forward,
    synthetic_corpus,
    train,
)

__all__ = [
    "KVCache",
    "LMBlock",
    "TransformerLM",
    "chunked_token_cross_entropy",
    "decode_step",
    "generate",
    "make_optimizer",
    "make_pp_train_step",
    "make_train_step",
    "next_token_loss",
    "next_token_loss_pp",
    "pp_forward",
    "prefill",
    "quantize_for_decode",
    "shard_params",
    "synthetic_corpus",
    "token_cross_entropy",
    "train",
    "train_step_flops",
    "unshard_params",
]
