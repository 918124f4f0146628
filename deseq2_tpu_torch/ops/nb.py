"""Negative-binomial likelihood primitives (PyTorch, batched over genes).

Log-density in R's dnbinom_mu parameterization (src/DESeq2.cpp:369,
R/core.R:2208-2217):

    size = 1/alpha,  Var = mu + alpha * mu^2
    log f(y; mu, size) = lgamma(y+size) - lgamma(size) - lgamma(y+1)
                         + size*log(size/(size+mu)) + y*log(mu/(size+mu))

Each difference form has a large-c series branch used in float32 only:
the direct lgamma/digamma difference cancels catastrophically once
c = 1/alpha >> y (y is absorbed by rounding in y + c).  float64 keeps the
direct form everywhere.
"""

from __future__ import annotations

import torch


def _is_f64(t):
    return t.dtype == torch.float64


def _sums_of_powers(y):
    """S_k = sum_{j=0}^{y-1} j^k for k=1..4, closed forms."""
    s1 = y * (y - 1.0) / 2.0
    s2 = (y - 1.0) * y * (2.0 * y - 1.0) / 6.0
    s3 = s1 * s1
    s4 = s2 * (3.0 * y * y - 3.0 * y - 1.0) / 5.0
    return s1, s2, s3, s4


def _large_c(y, c):
    return c > 16.0 * torch.clamp(y, min=1.0)


def lgamma_diff_centered(y, c):
    """lgamma(y + c) - lgamma(c) - y*log(c), stable for c >> y.

    For integer y this is sum_{j<y} log(1 + j/c); past c > 16*y the
    float32 path uses the 4-term series of that sum (error below f32
    noise at the crossover)."""
    direct = torch.lgamma(y + c) - torch.lgamma(c) - y * torch.log(c)
    if _is_f64(direct):
        return direct
    s1, s2, s3, s4 = _sums_of_powers(y)
    ci = 1.0 / c
    series = ci * (s1 - ci * (s2 / 2.0 - ci * (s3 / 3.0 - ci * s4 / 4.0)))
    return torch.where(_large_c(y, c), series, direct)


def digamma_diff(y, c):
    """digamma(y + c) - digamma(c) = sum_{j<y} 1/(c+j), stable for large c
    (same crossover rule as lgamma_diff_centered)."""
    direct = torch.digamma(y + c) - torch.digamma(c)
    if _is_f64(direct):
        return direct
    s1, s2, s3, s4 = _sums_of_powers(y)
    ci = 1.0 / c
    series = ci * (y - ci * (s1 - ci * (s2 - ci * (s3 - ci * s4))))
    return torch.where(_large_c(y, c), series, direct)


def trigamma(z):
    """trigamma(z) for z > 0 by 16 recurrence shifts onto z >= 16 and the
    asymptotic series through z^-11 (|err| < 1e-16 there).
    torch.polygamma(1, .) is only good to ~5e-10 relative on the CPU."""
    acc = torch.zeros_like(z)
    for _ in range(16):
        small = z < 16.0
        acc = acc + torch.where(small, 1.0 / (z * z), torch.zeros_like(z))
        z = torch.where(small, z + 1.0, z)
    inv = 1.0 / z
    inv2 = inv * inv
    series = inv * (1.0 + inv * (0.5 + inv * (
        1.0 / 6.0 - inv2 * (1.0 / 30.0 - inv2 * (
            1.0 / 42.0 - inv2 * (1.0 / 30.0 - inv2 * 5.0 / 66.0))))))
    return acc + series


def trigamma_diff(y, c):
    """trigamma(y + c) - trigamma(c) = -sum_{j<y} 1/(c+j)^2, stable for
    large c."""
    direct = trigamma(y + c) - trigamma(c)
    if _is_f64(direct):
        return direct
    s1, s2, s3, _ = _sums_of_powers(y)
    ci = 1.0 / c
    series = -ci * ci * (y - ci * (2.0 * s1 - ci * (3.0 * s2
                                                    - ci * 4.0 * s3)))
    return torch.where(_large_c(y, c), series, direct)


def digamma_pos(z):
    """digamma(z) for z > 0 by 8 recurrence shifts onto z >= 8 and the
    Stirling series through z^-8 (|err| < 8e-12 at z = 8).  The plain
    twin of the CUDA kernels' device function: CUDA's math library has
    no digamma."""
    acc = torch.zeros_like(z)
    for _ in range(8):
        small = z < 8.0
        acc = acc - torch.where(small, 1.0 / z, torch.zeros_like(z))
        z = torch.where(small, z + 1.0, z)
    inv = 1.0 / z
    inv2 = inv * inv
    series = (torch.log(z) - 0.5 * inv
              - inv2 * (1.0 / 12.0
                        - inv2 * (1.0 / 120.0
                                  - inv2 * (1.0 / 252.0 - inv2 / 240.0))))
    return acc + series


def nb_logpmf(y, mu, alpha):
    """Elementwise NB log-pmf with mean mu, dispersion alpha (size =
    1/alpha), with the y = 0 convention 0 log 0 = 0."""
    size = 1.0 / alpha
    t = torch.where(y > 0, y * (torch.log(mu) - torch.log(size + mu)),
                    torch.zeros_like(mu))
    return (torch.lgamma(y + size) - torch.lgamma(size)
            - torch.lgamma(y + 1.0)
            + size * (torch.log(size) - torch.log(size + mu)) + t)


def nb_lgamma_const(y, alpha):
    """mu-independent part of the NB log-pmf:
    lgamma(y+size) - lgamma(size) - lgamma(y+1) + size*log(size)."""
    size = 1.0 / alpha
    return (torch.lgamma(y + size) - torch.lgamma(size)
            - torch.lgamma(y + 1.0) + size * torch.log(size))
