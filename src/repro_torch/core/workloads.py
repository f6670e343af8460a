"""Workload generators (paper §6 experiments and TRIM op streams), numpy
only.

The counterpart of ``repro.core.workloads``: the same phases and the same
``numpy.random.Generator`` draws, so one seed gives the JAX package and this
package the identical write stream. A phase is (group sizes in pages,
per-group update probabilities, optional per-group TRIM probabilities);
events are i.i.d.: group ~ Categorical(p), page ~ Uniform(group), and, with
trim probabilities, op ~ Bernoulli(trim_probs[group]) over {WRITE, TRIM}.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
