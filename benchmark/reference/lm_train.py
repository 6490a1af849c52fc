"""Plain reference of the LM's first training steps: the next-token
cross-entropy of ``reference/transformer_lm`` in float32 with TF32 off,
its gradient by autograd over blocks of rows (the mean over every token
of the batch), and optax's ``adamw`` (``b1`` 0.9, ``b2`` 0.999, ``eps``
1e-8, decoupled weight decay, a constant rate), step by step.

``compute`` = "fp8" gives the control: every product's two operands are
rounded to float8 e4m3 (a per-tensor scale to the format's largest
value) before a float32 product, the nearest precision below the bf16
compute that the configuration states.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference import transformer_lm as lm

B1, B2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def fp8_products():
    """Round both operands of every ``@`` to float8 e4m3 for the span."""
    fmax = torch.finfo(torch.float8_e4m3fn).max

    def q(t):
        s = torch.clamp_min(t.detach().abs().amax(), 1e-12) / fmax
        return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s

    class _Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return q(t)

        @staticmethod
        def backward(ctx, g):
            return q(g)

    orig = torch.Tensor.__matmul__

    def matmul(a, b):
        return orig(_Round.apply(a), _Round.apply(b))

    torch.Tensor.__matmul__ = matmul
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = orig


def loss_and_grads(w: dict, config: dict, tokens: torch.Tensor, rows: int, compute: str):
    """(mean next-token CE over the batch, {name: gradient})."""
    params = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    b, s1 = tokens.shape
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    ctx = fp8_products() if compute == "fp8" else contextlib.nullcontext()
    with lm.exact_f32(), ctx:
        for r in range(0, b, rows):
            t = tokens[r : r + rows]
            x = lm.hidden(params, config, t[:, :-1])
            logits = lm.logits(params, config, x)
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), t[:, 1:].reshape(-1),
                                 reduction="sum")
            part = torch.autograd.grad(ce / (b * (s1 - 1)), list(params.values()))
            for k, g in zip(params, part):
                grads[k] += g
            total += ce.detach().double()
            del x, logits, ce, part
    return float(total / (b * (s1 - 1))), grads


def adamw_step(w: dict, grads: dict, mu: dict, nu: dict, count: int, lr: float, wd: float):
    """One optax ``adamw`` step, in place; ``count`` is the step's number
    (1 for the first)."""
    bc1, bc2 = 1 - B1**count, 1 - B2**count
    for k in w:
        mu[k].mul_(B1).add_(grads[k], alpha=1 - B1)
        nu[k].mul_(B2).addcmul_(grads[k], grads[k], value=1 - B2)
        upd = (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + EPS) + wd * w[k]
        w[k].sub_(lr * upd)


def first_steps(w0: dict, config: dict, batches: list, lr: float, wd: float,
                rows: int, compute: str = "float32") -> dict:
    """Follow the program through ``len(batches)`` steps from ``w0``:
    each step's loss, each leaf's first gradient norm and each leaf's
    change after the last step."""
    w = {k: v.detach().clone().float() for k, v in w0.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, g1 = [], None
    for i, tokens in enumerate(batches):
        loss, grads = loss_and_grads(w, config, tokens, rows, compute)
        losses.append(loss)
        if i == 0:
            g1 = {k: float(g.norm()) for k, g in grads.items()}
        with torch.no_grad():
            adamw_step(w, grads, mu, nu, i + 1, lr, wd)
        del grads
    delta = {k: float((w[k] - w0[k]).norm()) for k in w}
    return {"losses": losses, "grad_norms": g1, "delta_norms": delta}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The largest ``|‖x_p‖ - ‖x_r‖|`` over the leaves (those in ``keep``),
    each against the larger of its reference norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    norms = sorted(ref[k] for k in names)
    median = norms[len(norms) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in names)
