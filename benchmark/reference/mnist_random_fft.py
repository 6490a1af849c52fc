"""Plain reference of the MNIST random-FFT fit, in float64 with PyTorch
operations only (no kernel, no cache, nothing of the program).

KeystoneML's ``MnistRandomFFT``: each of ``numFFTs`` draws flips the
signs of a row's pixels, zero-pads it to ``n = next_pow2(d)``, takes the
real part of the first ``n / 2`` FFT coefficients and rectifies them;
the draws' features sit side by side (D columns). Labels become ±1
indicators. The fit is block least squares: features and indicators
centred by their means, one block-coordinate pass over blocks of
``blockSize`` columns, each block solving ``(A_iᵀA_i + λI) x_i = A_iᵀ(B -
Σ_{j≠i} A_j x_j)``; the model predicts ``(F - μ) X + mean(B)``.

``gram_bits`` (4 or 8) puts a lower precision in the Gram's place, as
the control that the comparison has to fail: each chunk of rows is
centred, quantized per column to symmetric ``gram_bits``-bit codes,
contracted exactly, and merged with Chan's update.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def next_pow2(d: int) -> int:
    n = 1
    while n < d:
        n *= 2
    return n


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 values rounded to ``bits`` explicit mantissa bits (TF32:
    10), to nearest, as float64."""
    drop = 23 - bits
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32).to(F64)


def features(x: torch.Tensor, signs: torch.Tensor, operand_bits: int | None = None) -> torch.Tensor:
    """(rows, d) pixels and (draws, d) ±1 signs → (rows, draws · n/2)
    rectified real FFT features, draw by draw, in float64. With
    ``operand_bits`` (the control) the real FFT is the product of the
    signed rows and the cosine table, both rounded to that many mantissa
    bits first, as a TF32 product would round them."""
    rows, d = x.shape
    n = next_pow2(d)
    xs = x.to(F64)[:, None, :] * signs.to(F64)[None, :, :]
    if operand_bits is not None:
        k = torch.arange(n // 2, dtype=F64, device=x.device)
        j = torch.arange(d, dtype=F64, device=x.device)
        cos = torch.cos(2.0 * torch.pi * j[:, None] * k[None, :] / n)
        re = round_mantissa(xs, operand_bits) @ round_mantissa(cos, operand_bits)
        return torch.clamp_min(re, 0.0).reshape(rows, -1)
    padded = torch.nn.functional.pad(xs, (0, n - d))
    re = torch.fft.fft(padded, dim=-1).real[..., : n // 2]
    return torch.clamp_min(re, 0.0).reshape(rows, -1)


def indicators(labels: torch.Tensor, k: int) -> torch.Tensor:
    y = -torch.ones((labels.shape[0], k), dtype=F64, device=labels.device)
    y[torch.arange(labels.shape[0], device=labels.device), labels.long()] = 1.0
    return y


def _quantized_gram(a: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp_min(a.abs().amax(dim=0, keepdim=True), 1e-12) / qmax
    q = torch.clamp(torch.round(a / scale), -qmax, qmax)
    return (q.T @ q) * (scale.T * scale)


def statistics(x, labels, signs, k: int, device, block_rows: int = 2048,
               gram_bits: int | None = None, chunk_rows: int = 8192,
               feature_bits: int | None = None):
    """Centred (AᵀA, AᵀB) and the means of the features and indicators,
    over every row, in float64."""
    n = x.shape[0]
    dim = signs.shape[0] * (next_pow2(x.shape[1]) // 2)
    ata = torch.zeros((dim, dim), dtype=F64, device=device)
    atb = torch.zeros((dim, k), dtype=F64, device=device)
    mu_a = torch.zeros(dim, dtype=F64, device=device)
    mu_b = torch.zeros(k, dtype=F64, device=device)
    seen = 0
    step = chunk_rows if gram_bits else block_rows
    signs = signs.to(device)
    for s in range(0, n, step):
        a = features(x[s : s + step].to(device), signs, feature_bits)
        b = indicators(labels[s : s + step].to(device), k)
        m = a.shape[0]
        ma, mb = a.mean(0), b.mean(0)
        ac, bc = a - ma, b - mb
        gram = _quantized_gram(ac, gram_bits) if gram_bits else ac.T @ ac
        w = seen * m / (seen + m)
        da, db = ma - mu_a, mb - mu_b
        ata += gram + w * torch.outer(da, da)
        atb += ac.T @ bc + w * torch.outer(da, db)
        mu_a += (m / (seen + m)) * da
        mu_b += (m / (seen + m)) * db
        seen += m
        del a, ac, gram
    return ata, atb, mu_a, mu_b


def bcd(ata, atb, lam: float, block: int, passes: int = 1) -> torch.Tensor:
    """Block coordinate descent on the centred normal equations."""
    dim = ata.shape[0]
    x = torch.zeros_like(atb)
    eye = torch.eye(block, dtype=F64, device=ata.device)
    for _ in range(passes):
        for s in range(0, dim, block):
            e = min(dim, s + block)
            g = ata[s:e, s:e]
            rhs = atb[s:e] - ata[s:e] @ x + g @ x[s:e]
            chol = torch.linalg.cholesky(g + lam * eye[: e - s, : e - s])
            x[s:e] = torch.cholesky_solve(rhs, chol)
    return x


def fit(x, labels, signs, config: dict, device, gram_bits: int | None = None,
        feature_bits: int | None = None):
    """The reference model (X (D, K), μ (D,), intercept (K,)); the two
    ``*_bits`` give the control."""
    k = config["num_classes"]
    ata, atb, mu_a, mu_b = statistics(x, labels, signs, k, device, gram_bits=gram_bits,
                                      feature_bits=feature_bits)
    xs = bcd(ata, atb, config["lambda"], config["blockSize"], config["solver_passes"])
    del ata
    return xs, mu_a, mu_b


def prediction_errors(x, signs, ref, models, device, block_rows: int = 2048) -> list[float]:
    """For each model (X, μ, b) in ``models``: ``‖P - P_ref‖ / ‖P_ref -
    b_ref‖`` over every row, the predictions ``(F - μ) X + b`` taken on
    the reference's float64 features."""
    rx, rmu, rb = ref
    signs = signs.to(device)
    xs = torch.stack([m[0].to(device, F64) for m in models])  # (M, D, K)
    mus = torch.stack([m[1].to(device, F64) for m in models])  # (M, D)
    bs = torch.stack([m[2].to(device, F64) for m in models])  # (M, K)
    num = torch.zeros(len(models), dtype=F64, device=device)
    den = torch.zeros((), dtype=F64, device=device)
    for s in range(0, x.shape[0], block_rows):
        f = features(x[s : s + block_rows].to(device), signs)
        pr = (f - rmu) @ rx
        den += (pr * pr).sum()
        pr = pr + rb
        offset = bs - torch.einsum("md,mdk->mk", mus, xs)
        p = torch.einsum("nd,mdk->mnk", f, xs) + offset[:, None, :]
        num += ((p - pr) ** 2).sum(dim=(1, 2))
    return (num.sqrt() / den.sqrt()).tolist()


def mean_errors(ref, models) -> list[float]:
    """For each model: ``‖μ - μ_ref‖ / ‖μ_ref‖`` of its feature means, the
    centring that every prediction subtracts."""
    rmu = ref[1]
    return [float((m[1].to(rmu.device, F64) - rmu).norm() / rmu.norm()) for m in models]
