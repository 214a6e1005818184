"""Rows at the shape of YearPredictionMSD, made on the device from the seed.

Each song has a release year and 90 audio columns: the means of its 12 timbre
coefficients over the song's segments, then the 78 entries of the upper triangle of their
12×12 covariance (12 variances, 66 covariances). Here the year is 2011 minus a log-normal
age (median about 9 years, so skewed toward the 2000s as the published set is), clipped
at 1922. A song's timbre is a low-rank draw: its covariance is F·Fᵀ + noise for a 12×4
loading F whose scale and direction drift with the year, and its means drift with the
year through a smooth nonlinear curve, so the year can be learned but no column gives
it. The columns keep the published scales: the first mean (loudness) about 43, the other
means tens, the variances thousands.
"""

import torch

TIMBRE = 12


def make(config: dict, seed: int, device: torch.device, parts: tuple[str, ...]) -> dict[str, torch.Tensor]:
    """``X``, ``y`` (and ``X_test``, ``y_test`` when ``"test"`` is in ``parts``) in float64 on
    ``device``: the training rows first, then the held-out rows, from one generator."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = torch.float64
    n_train, n_test = int(config["n_train"]), int(config["n_test"])
    n = n_train + n_test
    age = torch.exp(2.2 + 0.8 * torch.randn(n, generator=g, device=device, dtype=f64))
    year = (float(config["year_max"]) - torch.floor(age)).clamp_min(float(config["year_min"]))
    t = (year - 1998.0) / 11.0
    scales = torch.tensor([6.0, 50.0, 35.0, 16.0, 22.0, 13.0, 14.0, 8.0, 10.0, 6.0, 7.0, 5.0], dtype=f64, device=device)
    centre = torch.tensor([43.0, 1.0, 8.0, 1.0, -6.0, -9.0, -2.0, -1.0, -2.0, 0.5, 0.3, 1.0], dtype=f64, device=device)
    drift = torch.randn((3, TIMBRE), generator=g, device=device, dtype=f64)
    curve = torch.stack([t, torch.tanh(1.5 * t), t * t / 4], dim=1)  # (n, 3)
    means = centre + scales * (0.45 * curve @ drift + 0.8 * torch.randn((n, TIMBRE), generator=g, device=device, dtype=f64))
    loading = torch.randn((n, TIMBRE, 4), generator=g, device=device, dtype=f64)
    loading = loading * (scales[None, :, None] * (1.0 + 0.25 * torch.tanh(t))[:, None, None])
    cov = loading @ loading.mT / 4
    cov = cov + torch.diag_embed(0.2 * scales**2 * torch.rand((n, TIMBRE), generator=g, device=device, dtype=f64))
    upper = torch.triu_indices(TIMBRE, TIMBRE, device=device)
    X = torch.cat([means, cov[:, upper[0], upper[1]]], dim=1).contiguous()
    out = {"X": X[:n_train], "y": year[:n_train]}
    if "test" in parts:
        out["X_test"], out["y_test"] = X[n_train:], year[n_train:]
    return out
