"""Rows at the shape of HIGGS, made on the device from the seed.

HIGGS has 21 low-level columns of a simulated collision (the lepton's transverse momentum,
pseudorapidity and azimuth, the missing energy's magnitude and azimuth, and four jets'
momentum, pseudorapidity, azimuth and b-tag) and 7 high-level invariant masses that
physicists derived from them (m_jj, m_jjj, m_lv, m_jlv, m_bb, m_wbb, m_wwbb). The rows here
follow that layout: momenta log-normal (skewed, about 1 as in the published scaling),
pseudorapidities normal within ±2.5, azimuths uniform, b-tags on three discrete levels, and
each mass the invariant mass of its objects with a log-normal smearing. The label is 1 for
the 53% of rows with the highest value of a noisy nonlinear score of the masses, the
b-tags and the lepton's pseudorapidity, so that no column decides it alone.
"""

import math

import torch


def _mass(pt_a, eta_a, phi_a, pt_b, eta_b, phi_b):
    """Invariant mass of two massless objects: √(2·pTa·pTb·(cosh Δη − cos Δφ))."""
    return torch.sqrt((2 * pt_a * pt_b * (torch.cosh(eta_a - eta_b) - torch.cos(phi_a - phi_b))).clamp_min(1e-6))


def _rows(n: int, g: torch.Generator, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    f32 = torch.float32
    pt = torch.exp(0.45 * torch.randn((6, n), generator=g, device=device, dtype=f32) - 0.1)  # lepton, MET, 4 jets
    eta = (1.1 * torch.randn((5, n), generator=g, device=device, dtype=f32)).clamp(-2.5, 2.5)  # lepton, 4 jets
    phi = math.pi * (2 * torch.rand((6, n), generator=g, device=device, dtype=f32) - 1)
    u = torch.rand((4, n), generator=g, device=device, dtype=f32)
    btag = torch.where(u < 0.55, 0.0, torch.where(u < 0.8, 1.0865, 2.173)).to(f32)
    smear = torch.exp(0.08 * torch.randn((7, n), generator=g, device=device, dtype=f32))
    zero = torch.zeros_like(pt[0])
    lep, met, jets = (pt[0], eta[0], phi[0]), (pt[1], zero, phi[1]), [(pt[2 + j], eta[1 + j], phi[2 + j]) for j in range(4)]
    m_jj = _mass(*jets[0], *jets[1])
    m_jjj = torch.sqrt(m_jj**2 + _mass(*jets[0], *jets[2]) ** 2 + _mass(*jets[1], *jets[2]) ** 2)
    m_lv = _mass(*lep, *met)
    m_jlv = torch.sqrt(m_lv**2 + _mass(*jets[0], *lep) ** 2 + _mass(*jets[0], *met) ** 2)
    m_bb = _mass(*jets[2], *jets[3])
    m_wbb = torch.sqrt(m_jj**2 + m_bb**2 + _mass(*jets[0], *jets[2]) ** 2)
    m_wwbb = torch.sqrt(m_wbb**2 + m_jlv**2)
    high = torch.stack([m_jj, m_jjj, m_lv, m_jlv, m_bb, m_wbb, m_wwbb]) * smear
    high = high / high.mean(dim=1, keepdim=True)
    low = [lep[0], lep[1], lep[2], met[0], met[2]]
    for j in range(4):
        low += [jets[j][0], jets[j][1], jets[j][2], btag[j]]
    X = torch.cat([torch.stack(low), high]).T.contiguous()
    score = (
        1.6 * torch.exp(-(((high[4] - 1.0) / 0.35) ** 2))
        + 0.9 * torch.tanh(2.0 * (high[6] - 1.0))
        + 0.35 * (btag[2] + btag[3])
        - 0.4 * lep[1].abs()
        + 0.3 * torch.sin(3 * high[0]) * high[2]
        + 0.9 * torch.randn(n, generator=g, device=device, dtype=f32)
    )
    return X, score


def make(config: dict, seed: int, device: torch.device, parts: tuple[str, ...]) -> dict[str, torch.Tensor]:
    """``X``, ``y`` (and ``X_test``, ``y_test`` when ``"test"`` is in ``parts``) in float32 on
    ``device``: the training rows first, then the held-out rows, from one generator."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n_train, n_test = int(config["n_train"]), int(config["n_test"])
    X, score = _rows(n_train + n_test, g, device)
    positives = round(config["positive_share"] * len(score))
    cut = torch.kthvalue(score.cpu(), len(score) - positives).values.to(device)
    y = (score > cut).to(torch.float32)
    out = {"X": X[:n_train], "y": y[:n_train]}
    if "test" in parts:
        out["X_test"], out["y_test"] = X[n_train:], y[n_train:]
    return out
