"""The event streams, drawn from a drive's seed: a frozen copy of the
program's on-device sampling recipe, in plain torch operations.

A drive's traffic is a sequence of phases; a phase is a list of groups,
each a fraction of the logical span with a share of the events and a TRIM
probability. Every event's phase is found from the phase counts, its group
by comparing a uniform draw with the phase's CDF (clamped to the phase's
last group), its page uniformly within the group, and, in an op stream, a
third uniform draw makes it a TRIM with the group's probability. The
draws come from one ``torch.Generator`` seeded by the drive's seed, in
that order, so the same seed on the same device draws the same stream as
the program's sampler; the benchmark checks that it does.
"""

from __future__ import annotations

import numpy as np

from wabench.reference import split_sizes


def phase_groups(phase: dict, lba: int):
    """(sizes in pages, event shares, TRIM probabilities) of a traffic
    phase (``{"events": n, "groups": [{"frac", "weight", "trim"}...]}``):
    the shares are the weights over their sum, in float64."""
    groups = phase["groups"]
    sizes = split_sizes(lba, [g["frac"] for g in groups])
    w = np.asarray([g["weight"] for g in groups], np.float64)
    probs = [float(v) for v in w / w.sum()]
    trims = [float(g.get("trim", 0.0)) for g in groups]
    return sizes, probs, trims


def param_arrays(phases: list[dict], lba: int) -> dict:
    """The phases as zero-padded arrays: probs, sizes, offsets, trim
    probabilities [P, G]; counts and group counts [P]."""
    p_n = len(phases)
    g_n = max(len(ph["groups"]) for ph in phases)
    out = {
        "probs": np.zeros((p_n, g_n), np.float32),
        "sizes": np.zeros((p_n, g_n), np.int64),
        "offsets": np.zeros((p_n, g_n), np.int64),
        "trim_probs": np.zeros((p_n, g_n), np.float32),
        "counts": np.zeros(p_n, np.int64),
        "n_groups": np.ones(p_n, np.int64),
    }
    for i, ph in enumerate(phases):
        sizes, probs, trims = phase_groups(ph, lba)
        k = len(sizes)
        out["probs"][i, :k] = probs
        out["sizes"][i, :k] = sizes
        out["offsets"][i, :k] = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        out["trim_probs"][i, :k] = trims
        out["counts"][i] = int(ph["events"])
        out["n_groups"][i] = k
    return out


def draw(seed: int, params: dict, n_total: int, with_ops: bool, device):
    """One drive's stream: (ops [n] int32 or None, lbas [n] int32), on
    ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def t(name, dtype):
        return torch.as_tensor(params[name], dtype=dtype, device=device)

    counts = t("counts", torch.int64)
    probs = t("probs", torch.float32)
    sizes, offsets = t("sizes", torch.int64), t("offsets", torch.int64)
    n_groups = t("n_groups", torch.int64)
    pos = torch.arange(n_total, device=device)
    ph = torch.searchsorted(torch.cumsum(counts, 0), pos, right=True)
    ph = ph.clamp(max=counts.shape[0] - 1)
    u_grp = torch.rand(n_total, generator=gen, device=device)
    u_page = torch.rand(n_total, generator=gen, device=device)
    cdf = torch.cumsum(probs, 1)
    g = (u_grp[:, None] >= cdf[ph]).sum(1)
    g = torch.minimum(g, n_groups[ph] - 1)
    size = sizes[ph, g]
    within = torch.minimum((u_page * size.to(torch.float32)).long(),
                           size - 1)
    lbas = (offsets[ph, g] + within).to(torch.int32)
    if not with_ops:
        return None, lbas
    u_op = torch.rand(n_total, generator=gen, device=device)
    ops = (u_op < t("trim_probs", torch.float32)[ph, g]).to(torch.int32)
    return ops, lbas


def drive_seed(seed: int, experiment: int, drive: int) -> int:
    """A drive's seed, from the run's seed, the experiment and the drive
    (splitmix64 over the three, kept below 2**63)."""
    mask = (1 << 64) - 1
    x = seed & mask
    for v in (experiment, drive):
        x = (x ^ (v + 0x9E3779B97F4A7C15 + (x << 6) + (x >> 2))) & mask
        x = (x + 0x9E3779B97F4A7C15) & mask
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        x = z ^ (z >> 31)
    return x >> 1
