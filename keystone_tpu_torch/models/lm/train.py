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

- with a ``checkpoint_dir``, :func:`train` checkpoints the parameters and
  the optimizer state every ``checkpoint_every`` steps (and on the way out
  of a preemption, a signal or a crash) through
  :class:`keystone_tpu_torch.core.checkpoint.TrainCheckpointer`, and a
  rerun resumes from the newest intact step on the same trajectory.

The JAX package's loss guard and step watchdog, data-parallel batch
sharding over a mesh and the pipeline-parallel steps are not ported yet;
asking for one raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import signal
import threading
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


def _refuse_unported(*, model, batch, mesh, guard, step_timeout_s) -> None:
    """Raise for each of ``train``'s options whose machinery the port does
    not have yet, naming the ROADMAP step that brings it."""
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


def _run_identity(model: TransformerLM, corpus, *, batch, seq, lr, seed, schedule,
                  grad_clip, logit_chunk) -> dict:
    """Everything that shapes a run's trajectory, for the checkpoint's
    identity check; ``steps`` is left out on purpose (resuming with a
    longer schedule is the point; the over-trained guard covers a shorter
    one)."""
    corpus_head = np.asarray(corpus[:64], np.int64)
    return {
        "kind": "lm_transformer",
        "batch": batch,
        "seq": seq,
        "lr": lr,
        "seed": seed,
        "schedule": schedule,
        "grad_clip": grad_clip,
        "logit_chunk": logit_chunk,
        # the port has no guarded step (ROADMAP A8): always the plain one
        "guarded": False,
        "num_heads": model.num_heads,
        "num_kv_heads": model.kv_heads,
        "seq_mode": model.seq_mode,
        "compute_dtype": model.compute_dtype,
        "pos_encoding": model.pos_encoding,
        "remat": model.remat,
        "remat_policy": model.remat_policy,
        "moe_aux_weight": model.moe_aux_weight,
        "moe_experts": [None if m is None else m.num_experts for m in model.moe_layers],
        "moe_capacity": [None if m is None else m.capacity_factor for m in model.moe_layers],
        "corpus_len": int(len(corpus)),
        "corpus_head_sha": hashlib.sha256(corpus_head.tobytes()).hexdigest()[:16],
        "param_shapes": [list(map(int, leaf.shape)) for leaf in model.leaves()],
    }


def _legacy_defaults(model: TransformerLM) -> dict:
    """Values for identity keys that older checkpoints lack: what the
    code used before the key existed."""
    return {
        "pos_encoding": "learned",
        "schedule": "constant",
        "grad_clip": 0.0,
        "logit_chunk": 0,
        "guarded": False,
        "remat_policy": "full",
        "num_kv_heads": model.num_heads,
    }


def _train_state(model: TransformerLM, opt_state: AdamWState) -> dict:
    """The checkpointed state: every parameter, both moments and the
    update count (a host int, saved as a tensor)."""
    return {
        "params": model.leaves(),
        "mu": opt_state.mu,
        "nu": opt_state.nu,
        "count": torch.tensor(opt_state.count, dtype=torch.int64),
    }


def _emit_resilience(action: str, **fields) -> None:
    from keystone_tpu_torch.resilience.emit import decision

    decision(action, **fields)


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
    (model, losses), the model updated in place; ``losses`` are this
    call's steps'. A sequence-parallel model takes its mesh from the
    model; the batch is not sharded. Batches derive from ``(seed, step)``.
    ``logit_chunk`` chunks the CE.

    ``checkpoint_dir`` checkpoints every ``checkpoint_every`` steps (0:
    ``steps // 10``, about ten a run) and at the last step; a rerun on the
    directory resumes from its newest intact step. SIGTERM and SIGINT
    stop the loop after the step in flight, and the ``finally`` path
    checkpoints the last completed step, so a preemption loses at most
    the step in flight. The ``train.preempt`` and ``train.sigterm`` fault
    sites, keyed by the step, drill both paths.

    Not ported yet, and raising ``NotImplementedError``: a ``guard`` or
    ``KEYSTONE_GUARD``, ``step_timeout_s`` or ``KEYSTONE_STEP_TIMEOUT_S``
    (A8), and a ``mesh`` whose data axis would shard a local model's batch
    (A6)."""
    from keystone_tpu_torch.resilience import faults as _faults
    from keystone_tpu_torch.resilience.retry import RetryExhausted

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
    _refuse_unported(model=model, batch=batch, mesh=mesh, guard=guard,
                     step_timeout_s=step_timeout_s)
    optimizer = make_optimizer(lr, steps=steps, schedule=schedule, grad_clip=grad_clip)
    opt_state = optimizer.init(model.leaves())
    step = make_train_step(optimizer, logit_chunk=logit_chunk)
    losses = []

    ckpt = None
    every = 0
    if checkpoint_dir:
        from keystone_tpu_torch.core.checkpoint import TrainCheckpointer

        every = checkpoint_every or max(steps // 10, 1)
        ckpt = TrainCheckpointer(
            checkpoint_dir,
            _run_identity(model, corpus, batch=batch, seq=seq, lr=lr, seed=seed,
                          schedule=schedule, grad_clip=grad_clip, logit_chunk=logit_chunk),
            legacy_defaults=_legacy_defaults(model),
            cluster_info={
                "num_processes": 1,
                "mesh": None if mesh is None else {k: int(v) for k, v in mesh.shape.items()},
            },
        )

    # first signal → flag only: the loop stops after the step in flight and
    # the finally path checkpoints. A second signal means the loop is not
    # getting back to its check: the previous handlers are restored and the
    # signal re-delivered, so a repeated Ctrl-C or SIGTERM escalates.
    stop_signal: dict = {"sig": None}
    prev_handlers: dict = {}
    if ckpt is not None and threading.current_thread() is threading.main_thread():

        def _on_signal(signum, frame):
            if stop_signal["sig"] is not None:
                for s, h in prev_handlers.items():
                    signal.signal(s, h)
                prev = prev_handlers.get(signum)
                if callable(prev):
                    prev(signum, frame)
                else:
                    signal.raise_signal(signum)
                return
            stop_signal["sig"] = signum

        for s in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[s] = signal.signal(s, _on_signal)

    start = completed = last_saved = 0
    try:
        if ckpt is not None:
            state, start = ckpt.restore(_train_state(model, opt_state))
            opt_state.count = int(state["count"])
            if start > steps:
                raise ValueError(
                    f"{checkpoint_dir} holds a step-{start} checkpoint but this run is "
                    f"only {steps} steps — refusing to return an over-trained model; "
                    "point at a fresh directory"
                )
        completed = last_saved = start
        for i in range(start, steps):
            toks = torch.from_numpy(_step_batch(corpus, seed, i, batch, seq)).to(model.device)
            model, opt_state, loss = step(model, opt_state, toks)
            # the loss stays on the device: a float() here would wait for
            # the step in every iteration
            losses.append(loss)
            completed = i + 1
            if log_every and (i + 1) % log_every == 0:
                logger.info("step %d loss %.4f", i + 1, float(loss))
            if ckpt is not None and ((i + 1) % every == 0 or (i + 1) == steps):
                try:
                    ckpt.save(_train_state(model, opt_state), i + 1)
                    last_saved = i + 1
                except (OSError, RetryExhausted) as e:
                    # a full disk at a PERIODIC save must not end the run:
                    # the previous checkpoint is intact (atomic), so go on
                    # loudly and try again at the next interval
                    logger.warning(
                        "periodic checkpoint save at step %d failed (%r); continuing on "
                        "the step-%d checkpoint", i + 1, e, last_saved,
                    )
                    _emit_resilience("ckpt_save_failed", counter="ckpt_save_failures",
                                     step=i + 1, last_saved=last_saved, error=repr(e))
            if _faults.fire("train.sigterm", key=i):
                if prev_handlers:
                    # a real signal to this process: the handler path end to end
                    signal.raise_signal(signal.SIGTERM)
                else:
                    logger.warning(
                        "train.sigterm fault fired at step %d but no handler is "
                        "installed; ignoring", i,
                    )
            if stop_signal["sig"] is not None:
                logger.warning(
                    "signal %d at step %d: writing the final checkpoint and stopping early",
                    stop_signal["sig"], i + 1,
                )
                _emit_resilience("signal_stop", signum=stop_signal["sig"], step=i + 1)
                break
            _faults.maybe_preempt(key=i)
    finally:
        try:
            if ckpt is not None and completed > last_saved:
                # preemption, signal or crash: the periodic save did not
                # cover the last completed step — write it now
                ckpt.save(_train_state(model, opt_state), completed)
                _emit_resilience("final_checkpoint", step=completed)
        except Exception:  # noqa: BLE001 — must not mask the original exception
            logger.exception("final checkpoint save at step %d failed", completed)
        finally:
            for s, h in prev_handlers.items():
                signal.signal(s, h)
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
