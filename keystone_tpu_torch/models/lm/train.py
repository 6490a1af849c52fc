"""LM training — port of ``keystone_tpu/models/lm/train.py``: the
optimizer, the train step, the loop and the synthetic corpus.

- :func:`make_optimizer` is optax's ``adamw`` (optionally behind
  ``clip_by_global_norm``, with a constant or warmup-cosine rate) written
  on torch tensors, step for step: every leaf is decayed (no mask), the
  decay is scaled by the scheduled rate, the schedule is read at the
  count before the increment and the bias correction at count + 1, and
  the clip scales by ``max_norm / g_norm`` only when ``g_norm ≥ max_norm``.
- :func:`make_train_step` is one call of loss, gradients and update; the
  loss stays a device scalar.
- :func:`train` draws each step's windows from ``(seed, step)`` alone.

The JAX package's checkpoint and resume hooks, its loss guard and step
watchdog, data-parallel batch sharding over a mesh and the
pipeline-parallel steps are not ported yet; asking for one raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable

import numpy as np
import torch

from keystone_tpu_torch.core.logging import get_logger
from keystone_tpu_torch.models.lm.losses import next_token_loss
from keystone_tpu_torch.models.lm.model import TransformerLM, has_quantized_leaves

logger = get_logger("keystone_tpu_torch.models.lm_transformer")

_F32 = np.float32
# optax.adamw's defaults, which the JAX package keeps
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax's ``linear_schedule`` (``polynomial_schedule`` at power 1), in
    float32, for ``transition_steps`` ≥ 1."""

    def schedule(count: int):
        c = _F32(min(max(count, 0), transition_steps))
        frac = _F32(1) - c / _F32(transition_steps)
        return _F32(_F32(init_value) - _F32(end_value)) * frac + _F32(end_value)

    return schedule


def _cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float):
    """optax's ``cosine_decay_schedule`` at exponent 1, in float32."""
    if not decay_steps > 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps=}."
        )

    def schedule(count: int):
        c = _F32(min(float(count), float(decay_steps)))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        decayed = _F32(1 - alpha) * cosine + _F32(alpha)
        return _F32(init_value) * decayed

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Callable[[int], np.float32]:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine down to
    ``end_value`` at ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = _linear_schedule(init_value, peak_value, warmup_steps)
    decay = _cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: the update count and the two moments
    (f32, one per leaf). The count lives on the host."""

    count: int
    mu: list
    nu: list


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``adamw`` — ``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_learning_rate`` — behind an optional
    ``clip_by_global_norm``. ``lr`` is a float or a schedule of the
    count. :meth:`update` changes the parameters and the state in place,
    with no host synchronisation."""

    lr: float | Callable[[int], np.float32]
    weight_decay: float = 0.01
    grad_clip: float = 0.0

    def init(self, params) -> AdamWState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamWState(count=0, mu=zeros, nu=[torch.zeros_like(z) for z in zeros])

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params) -> AdamWState:
        grads = list(grads)
        if self.grad_clip > 0.0:
            # optax.global_norm: sqrt of the sum over leaves of Σx²
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.grad_clip
            grads = [torch.where(keep, g, (g / g_norm) * self.grad_clip) for g in grads]
        b1, b2 = _B1, _B2
        # mu = (1 − b1)·g + b1·mu; nu = (1 − b2)·g² + b2·nu
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        count_inc = state.count + 1
        bc1 = float(_F32(1) - np.power(_F32(b1), _F32(count_inc), dtype=_F32))
        bc2 = float(_F32(1) - np.power(_F32(b2), _F32(count_inc), dtype=_F32))
        # mu_hat / (sqrt(nu_hat) + eps) + wd·p, times −lr(count)
        upd = torch._foreach_div(state.mu, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(state.nu, bc2))
        torch._foreach_add_(den, _EPS)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, torch._foreach_mul(list(params), self.weight_decay))
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        torch._foreach_mul_(upd, -float(_F32(lr)))
        torch._foreach_add_(list(params), upd)
        state.count = count_inc
        return state


def make_optimizer(
    lr: float,
    *,
    steps: int = 0,
    schedule: str = "constant",
    warmup_frac: float = 0.05,
    grad_clip: float = 0.0,
    weight_decay: float = 0.01,
) -> AdamW:
    """The LM training optimizer: AdamW, optionally behind global-norm
    gradient clipping, with a constant or warmup-cosine learning rate.
    ``schedule="cosine"`` warms up over ``warmup_frac`` of ``steps`` and
    decays to lr/10."""
    if schedule not in ("constant", "cosine"):
        raise ValueError(f"schedule={schedule!r}; expected constant|cosine")
    rate: float | Callable = lr
    if schedule == "cosine":
        if steps <= 0:
            raise ValueError("schedule='cosine' needs the total steps")
        rate = warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=lr,
            warmup_steps=max(1, int(steps * warmup_frac)),
            decay_steps=steps,
            end_value=lr / 10.0,
        )
    return AdamW(rate, weight_decay=weight_decay, grad_clip=grad_clip)


def make_train_step(optimizer: AdamW, *, logit_chunk: int = 0):
    """``step(model, opt_state, tokens) -> (model, opt_state, loss)``:
    next-token loss, the gradient of every float leaf, and the optimizer's
    update, in one call. The step turns on ``requires_grad`` of the leaves
    it updates; the model and the state are updated in place and handed
    back, as the JAX package's donated step hands back new ones. ``loss``
    is a device scalar. ``logit_chunk`` chunks the CE."""

    def step(model: TransformerLM, opt_state: AdamWState, tokens):
        params = model.leaves()
        for p in params:
            p.requires_grad_(True)
        loss = next_token_loss(model, tokens, logit_chunk=logit_chunk)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a leaf the loss never reads (rope's empty position table) has a
        # zero gradient
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        optimizer.update(grads, opt_state, params)
        return model, opt_state, loss.detach()

    return step


def _step_batch(corpus, seed: int, i: int, batch: int, seq: int):
    """Step ``i``'s token windows, derived from ``(seed, i)`` alone — no
    sequential RNG state, so a resumed run regenerates the exact batch
    sequence an uninterrupted run would have seen."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, i)))
    starts = rng.integers(0, len(corpus) - seq - 1, size=batch)
    return np.stack([corpus[s : s + seq + 1] for s in starts])


def _refuse_unported(*, model, batch, mesh, checkpoint_dir, guard, step_timeout_s) -> None:
    """Raise for each of ``train``'s options whose machinery the port does
    not have yet, naming the ROADMAP step that brings it."""
    if checkpoint_dir:
        raise NotImplementedError(
            "train(checkpoint_dir=...): checkpoint and resume come with ROADMAP A7"
        )
    env_guard = os.environ.get("KEYSTONE_GUARD", "")
    if (guard not in (None, "", "off")) or env_guard not in ("", "off"):
        raise NotImplementedError(
            "train(guard=...) / KEYSTONE_GUARD: the loss guard comes with ROADMAP A8"
        )
    env_timeout = float(os.environ.get("KEYSTONE_STEP_TIMEOUT_S", "0") or 0)
    if step_timeout_s > 0 or env_timeout > 0:
        raise NotImplementedError(
            "train(step_timeout_s=...) / KEYSTONE_STEP_TIMEOUT_S: the step "
            "watchdog comes with ROADMAP A8"
        )
    if (
        mesh is not None
        and model.seq_mode == "local"
        and mesh.shape.get("data", 1) > 1
        and batch % mesh.shape["data"] == 0
    ):
        raise NotImplementedError(
            "train(mesh=...) with a data axis would shard the batch of a local "
            "model: data-parallel training comes with ROADMAP A6"
        )


def train(
    model: TransformerLM,
    corpus: np.ndarray,
    *,
    steps: int,
    batch: int,
    seq: int,
    lr: float = 3e-4,
    mesh=None,
    seed: int = 0,
    log_every: int = 0,
    checkpoint_dir: str = "",
    checkpoint_every: int = 0,
    schedule: str = "constant",
    grad_clip: float = 0.0,
    logit_chunk: int = 0,
    guard=None,
    step_timeout_s: float = 0.0,
):
    """Train on random windows of ``corpus`` (1-D int array). Returns
    (model, losses), the model updated in place. A sequence-parallel model
    takes its mesh from the model; the batch is not sharded. Batches
    derive from ``(seed, step)``. ``logit_chunk`` chunks the CE.

    Not ported yet, and raising ``NotImplementedError``: a non-empty
    ``checkpoint_dir`` (ROADMAP A7; ``checkpoint_every`` is read only with
    it), a ``guard`` or ``KEYSTONE_GUARD``, ``step_timeout_s`` or
    ``KEYSTONE_STEP_TIMEOUT_S`` (A8), and a ``mesh`` whose data axis would
    shard a local model's batch (A6)."""
    del checkpoint_every
    if len(corpus) < seq + 2:
        raise ValueError(
            f"corpus of {len(corpus)} tokens is too short for seq={seq} "
            f"(needs at least seq+2 = {seq + 2}); shorten --seq or grow "
            "the corpus"
        )
    if has_quantized_leaves(model):
        raise ValueError(
            "model holds int8 QTensor weights (quantize_for_decode is "
            "inference-only) — gradients through the rounding would be "
            "silently zero; train the float model and re-quantize"
        )
    _refuse_unported(model=model, batch=batch, mesh=mesh, checkpoint_dir=checkpoint_dir,
                     guard=guard, step_timeout_s=step_timeout_s)
    optimizer = make_optimizer(lr, steps=steps, schedule=schedule, grad_clip=grad_clip)
    opt_state = optimizer.init(model.leaves())
    step = make_train_step(optimizer, logit_chunk=logit_chunk)
    losses = []
    for i in range(steps):
        toks = torch.from_numpy(_step_batch(corpus, seed, i, batch, seq)).to(model.device)
        model, opt_state, loss = step(model, opt_state, toks)
        # the loss stays on the device: a float() here would wait for the
        # step in every iteration
        losses.append(loss)
        if log_every and (i + 1) % log_every == 0:
            logger.info("step %d loss %.4f", i + 1, float(loss))
    return model, [float(x) for x in losses]


def synthetic_corpus(n: int, vocab: int, seed: int = 0) -> np.ndarray:
    """A learnable-but-not-trivial token stream: an order-1 Markov chain
    with a sparse, deterministic-ish transition structure."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, 4))
    probs = np.array([0.7, 0.15, 0.1, 0.05])
    out = np.empty(n, np.int32)
    out[0] = 0
    choices = rng.choice(4, size=n, p=probs)
    for i in range(1, n):
        out[i] = succ[out[i - 1], choices[i]]
    return out
