"""Workload generators (paper §6 experiments and TRIM op streams).

The counterpart of ``repro.core.workloads``: the same phases and the same
``numpy.random.Generator`` draws, so one seed gives the JAX package and this
package the identical write stream; and, for fleets, the same phase
sequence drawn on the device (:func:`sample_phases_device`). A phase is
(group sizes in pages, per-group update probabilities, optional per-group
TRIM probabilities); events are i.i.d.: group ~ Categorical(p), page ~
Uniform(group), and, with trim probabilities, op ~
Bernoulli(trim_probs[group]) over {WRITE, TRIM}.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

OP_WRITE, OP_TRIM = 0, 1


@dataclasses.dataclass(frozen=True)
class Phase:
    sizes: tuple[int, ...]  # pages per group (sums to LBA)
    probs: tuple[float, ...]  # update probability per group (sums to 1)
    n_writes: int  # events in this phase (writes + trims for op phases)
    # probability that an event hitting group g is a TRIM; () = pure-write
    trim_probs: tuple[float, ...] = ()

    @property
    def has_trim(self) -> bool:
        return any(t > 0.0 for t in self.trim_probs)

    def page_group(self) -> np.ndarray:
        return np.repeat(
            np.arange(len(self.sizes), dtype=np.int32), self.sizes
        )

    def page_rate(self) -> np.ndarray:
        """True per-page update rate (oracle detector input)."""
        rates = np.asarray(self.probs) / np.maximum(np.asarray(self.sizes), 1)
        return np.repeat(rates.astype(np.float32), self.sizes)

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        """Draw the phase's [n_writes] page stream (pure-write phases)."""
        if self.has_trim:
            raise ValueError("op phase: use sample_ops()")
        _, lbas = self._sample_events(rng)
        return lbas

    def sample_ops(self, rng: np.random.Generator):
        """Draw the phase's op stream: (ops [n], lbas [n]) int32 arrays. A
        pure-write phase consumes exactly the draws :meth:`sample` would."""
        groups, lbas = self._sample_events(rng)
        if not self.has_trim:
            return np.zeros(self.n_writes, np.int32), lbas
        tp = np.zeros(len(self.sizes))
        tp[: len(self.trim_probs)] = self.trim_probs
        ops = (rng.random(self.n_writes) < tp[groups]).astype(np.int32)
        return ops, lbas

    def _sample_events(self, rng: np.random.Generator):
        groups = rng.choice(
            len(self.probs), size=self.n_writes, p=np.asarray(self.probs)
        )
        offsets = np.concatenate([[0], np.cumsum(self.sizes)])[:-1]
        within = (
            rng.random(self.n_writes) * np.asarray(self.sizes)[groups]
        ).astype(np.int64)
        return groups, (offsets[groups] + within).astype(np.int32)


# ---------------------------------------------------------------------------
# on-device sampling (fleets)
# ---------------------------------------------------------------------------

def phase_param_arrays(phases, *, g_max: int | None = None,
                       p_max: int | None = None) -> dict:
    """Pad a phase sequence to fixed-shape numpy arrays for on-device
    sampling: probs/sizes/offsets/trim_probs [P, G] (zero-padded), counts
    [P] (events per phase; padded phases get 0 and are never reached),
    n_groups [P]. Drives of a fleet pad to shared (p_max, g_max)."""
    p_n = p_max or len(phases)
    g_n = g_max or max(len(ph.sizes) for ph in phases)
    if len(phases) > p_n:
        raise ValueError(f"{len(phases)} phases, padded to {p_n}")
    probs = np.zeros((p_n, g_n), np.float32)
    sizes = np.zeros((p_n, g_n), np.int32)
    offsets = np.zeros((p_n, g_n), np.int32)
    trim_probs = np.zeros((p_n, g_n), np.float32)
    counts = np.zeros(p_n, np.int32)
    n_groups = np.ones(p_n, np.int32)
    for i, ph in enumerate(phases):
        k = len(ph.sizes)
        probs[i, :k] = ph.probs
        sizes[i, :k] = ph.sizes
        offsets[i, :k] = np.concatenate([[0], np.cumsum(ph.sizes)])[:-1]
        trim_probs[i, : len(ph.trim_probs)] = ph.trim_probs
        counts[i] = ph.n_writes
        n_groups[i] = k
    return {
        "probs": probs, "sizes": sizes, "offsets": offsets,
        "trim_probs": trim_probs, "counts": counts, "n_groups": n_groups,
    }


def sample_phases_device(gen: torch.Generator, params: dict, n_total: int,
                         with_ops: bool = False):
    """Draw the [n_total] event stream of a phase sequence on ``gen``'s
    device (int32 page numbers; with ``with_ops`` the pair (ops, lbas)).

    The JAX package's algorithm: each event's phase by a searchsorted over
    the phase counts, its group by comparing a uniform draw with the
    phase's CDF (clamped to the phase's last group against float
    round-off), its page uniform within the group, and with ``with_ops``
    a third uniform draw decides a TRIM by the group's trim probability.
    The same distribution as :meth:`Phase.sample`, drawn from ``gen``
    (seed it from the drive's seed alone): a different stream from numpy's
    and from ``jax.random``'s.
    """
    dev = gen.device

    def t(name, dtype):
        return torch.as_tensor(params[name], dtype=dtype, device=dev)

    counts, probs = t("counts", torch.int64), t("probs", torch.float32)
    sizes, offsets = t("sizes", torch.int64), t("offsets", torch.int64)
    n_groups = t("n_groups", torch.int64)
    pos = torch.arange(n_total, device=dev)
    ph = torch.searchsorted(torch.cumsum(counts, 0), pos, right=True)
    ph = ph.clamp(max=counts.shape[0] - 1)
    u_grp = torch.rand(n_total, generator=gen, device=dev)
    u_page = torch.rand(n_total, generator=gen, device=dev)
    cdf = torch.cumsum(probs, 1)  # [P, G]
    g = (u_grp[:, None] >= cdf[ph]).sum(1)
    g = torch.minimum(g, n_groups[ph] - 1)  # float-roundoff tail guard
    size = sizes[ph, g]
    within = torch.minimum((u_page * size.to(torch.float32)).long(),
                           size - 1)
    lbas = (offsets[ph, g] + within).to(torch.int32)
    if not with_ops:
        return lbas
    u_op = torch.rand(n_total, generator=gen, device=dev)
    ops = (u_op < t("trim_probs", torch.float32)[ph, g]).to(torch.int32)
    return ops, lbas


def split_sizes(lba: int, fracs) -> tuple[int, ...]:
    fracs = np.asarray(fracs, np.float64)
    fracs = fracs / fracs.sum()
    sizes = np.floor(fracs * lba).astype(int)
    sizes[-1] += lba - sizes.sum()
    return tuple(int(s) for s in sizes)


def uniform(lba: int, n_writes: int) -> Phase:
    """§4: uniform random over the whole LBA (single group)."""
    return Phase((lba,), (1.0,), n_writes)


def two_modal(lba: int, n_writes: int, *, p_hot=0.9, frac_hot=0.5) -> Phase:
    sizes = split_sizes(lba, [1 - frac_hot, frac_hot])
    return Phase(sizes, (1 - p_hot, p_hot), n_writes)


def swap_phases(
    lba: int, writes_per_phase: int, *, p=(0.1, 0.9), fracs=(0.5, 0.5)
) -> tuple[Phase, Phase]:
    """§6.1 frequency swap: two equal groups whose probabilities swap."""
    sizes = split_sizes(lba, fracs)
    return (
        Phase(sizes, tuple(p), writes_per_phase),
        Phase(sizes, tuple(reversed(p)), writes_per_phase),
    )


def exponential_groups(lba: int, n_writes: int, n_groups: int = 5) -> Phase:
    """§6.1 generalization: exponentially increasing update frequencies
    (~3.2%, 6.4%, …, 51.2% for 5 groups), equal sizes."""
    raw = np.array([2.0 ** i for i in range(n_groups)])
    probs = tuple(raw / raw.sum())
    sizes = split_sizes(lba, [1.0] * n_groups)
    return Phase(sizes, probs, n_writes)


def pairwise_swap(phase: Phase, i: int, j: int, n_writes: int) -> Phase:
    """Swap the update frequencies of groups i and j (Fig. 8 matrix)."""
    probs = list(phase.probs)
    probs[i], probs[j] = probs[j], probs[i]
    return Phase(phase.sizes, tuple(probs), n_writes)


def tpcc_like(lba: int, n_writes: int) -> Phase:
    """TPC-C_init-shaped synthetic (paper Fig. 9): a hot and a warm cluster
    (~8× apart per page) over a cold majority (54% of pages)."""
    sizes = split_sizes(lba, [0.54, 0.26, 0.20])
    agg = np.array([0.54 * 0.02, 0.26 * 1.0, 0.20 * 8.0])
    probs = tuple(agg / agg.sum())
    return Phase(sizes, probs, n_writes)


# ---------------------------------------------------------------------------
# op-stream (TRIM) workloads
# ---------------------------------------------------------------------------

def trimmed(phase: Phase, trim_frac) -> Phase:
    """Interleave TRIMs into any phase: each event that hits group g is a
    TRIM with probability ``trim_frac`` (scalar) or ``trim_frac[g]``. With
    uniform page choice inside the group, about that fraction of the
    group's pages is unmapped at steady state."""
    if np.ndim(trim_frac) == 0:
        tp = (float(trim_frac),) * len(phase.sizes)
    else:
        if len(trim_frac) != len(phase.sizes):
            raise ValueError(f"{len(trim_frac)} trim fractions for "
                             f"{len(phase.sizes)} groups")
        tp = tuple(float(t) for t in trim_frac)
    if not all(0.0 <= t <= 1.0 for t in tp):
        raise ValueError(f"trim fractions outside [0, 1]: {tp}")
    return dataclasses.replace(phase, trim_probs=tp)


def utilization_sweep(lba: int, n_ops: int, trim_fracs=(0.0, 0.1, 0.25, 0.5)):
    """Single-group uniform phases holding trim fraction t of the LBA
    unmapped at steady state, one per entry of ``trim_fracs`` (each an
    independent drive, not a segment sequence)."""
    return [trimmed(uniform(lba, n_ops), t) for t in trim_fracs]


def tpcc_churn(lba: int, n_ops: int) -> Phase:
    """TPC-C table churn: the tpcc_like temperature shape with the
    insert/update/delete lifecycle. The cold group only writes, the warm
    group prunes lightly (5% TRIMs), and a third of the hot group's events
    are TRIMs (rows deleted on delivery)."""
    return trimmed(tpcc_like(lba, n_ops), (0.0, 0.05, 1.0 / 3.0))
