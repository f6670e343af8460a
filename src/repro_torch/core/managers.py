"""Block-manager presets (paper §6 comparison points) + run helpers.

The counterpart of ``repro.core.managers``: every preset, the
fault-injecting ``wolf_endurance`` included.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.simulator import SimContext, run
from repro_torch.core.ssd import Geometry, ManagerConfig, init_state
from repro_torch.core.workloads import Phase


def wolf(**kw) -> ManagerConfig:
    """The paper's system: measured stats, closed-form OP allocation,
    movement operations, greedy GC."""
    return ManagerConfig(
        name="wolf", alloc_mode="wolf", gc_policy="greedy",
        movement_ops=True, td_mode="static", **kw
    )


def wolf_dynamic(**kw) -> ManagerConfig:
    """Wolf with dynamic group creation/merging (§5.2) and the bloom
    detector (§5.6): the paper's TPC-C configuration."""
    return ManagerConfig(
        name="wolf-dynamic", alloc_mode="wolf", gc_policy="greedy",
        movement_ops=True, td_mode="bloom", dynamic_groups=True,
        max_groups=12, **kw
    )


def fdp(**kw) -> ManagerConfig:
    """Stoica et al. [20] as the paper characterises it: a fixed group
    order with ASSUMED frequencies (hit rate doubles per group), LRU GC, no
    movement operations; pages move between groups instead."""
    return ManagerConfig(
        name="fdp", alloc_mode="fdp_assumed", gc_policy="lru",
        movement_ops=False, td_mode="fdp", **kw
    )


def single_group(**kw) -> ManagerConfig:
    """Grey-line baseline: all pages mixed in one group."""
    return ManagerConfig(
        name="single", alloc_mode="single", gc_policy="greedy",
        movement_ops=False, td_mode="static", max_groups=kw.pop("max_groups", 1),
        **kw
    )


def wolf_lru(**kw) -> ManagerConfig:
    """Ablation for Fig. 2 (greedy vs LRU under movement operations)."""
    return ManagerConfig(
        name="wolf-lru", alloc_mode="wolf", gc_policy="lru",
        movement_ops=True, td_mode="static", **kw
    )


def wolf_wear(**kw) -> ManagerConfig:
    """Wolf with wear-leveling victim scoring (the ``wear`` weight point:
    α = 1, β = 0.25)."""
    return ManagerConfig(
        name="wolf-wear", alloc_mode="wolf", gc_policy="wear",
        movement_ops=True, td_mode="static", **kw
    )


def wolf_trim_aware(**kw) -> ManagerConfig:
    """Wolf with the τ term of the victim score: blocks rich in
    trimmed-but-unerased slots are deprioritised."""
    return ManagerConfig(
        name="wolf-trim-aware", alloc_mode="wolf", gc_policy="trim_aware",
        movement_ops=True, td_mode="static", **kw
    )


def wolf_endurance(**kw) -> ManagerConfig:
    """Wolf on an aging drive: a block dies once its P-E count reaches
    ``endurance_pe_limit`` (default 40; ``fault_rate_worn`` defaults to
    1.0), retires into the spare pool and shrinks the OP the §5.5
    allocator divides. ``fault_rate=...`` adds an age-independent
    failure floor."""
    return ManagerConfig(
        name="wolf-endurance", alloc_mode="wolf", gc_policy="greedy",
        movement_ops=True, td_mode="static",
        endurance_pe_limit=kw.pop("endurance_pe_limit", 40), **kw
    )


@dataclasses.dataclass
class RunResult:
    app: np.ndarray  # cumulative application writes
    mig: np.ndarray  # cumulative migrations
    state: object    # the final SimState
    # trace stride: element j covers events up to step (j+1)·stride - 1
    stride: int = 1
    host_syncs: int = 0  # device→host reads the run made for decisions

    @property
    def wa_total(self) -> float:
        return float((self.app[-1] + self.mig[-1]) / max(self.app[-1], 1))

    def wa_curve(self, window: int = 2000) -> np.ndarray:
        """Windowed WA over time: (Δapp+Δmig)/Δapp per window of ``window``
        events (a multiple of the trace stride; in an op stream a window
        counts writes and TRIMs, and Δapp only its writes)."""
        if window % self.stride:
            raise ValueError(f"window {window} is no multiple of {self.stride}")
        w = window // self.stride
        app, mig = self.app, self.mig
        idx = np.arange(w, len(app) + 1, w) - 1
        prev = np.maximum(idx - w, -1)
        d_app = app[idx] - np.where(prev >= 0, app[prev], 0)
        d_mig = mig[idx] - np.where(prev >= 0, mig[prev], 0)
        return np.where(d_app > 0, (d_app + d_mig) / np.maximum(d_app, 1), 1.0)


def fdp_assumed_arrays(phase: Phase, g_max: int):
    """FDP's FIXED assumptions, taken from the initial phase: group i+1 is
    2× hotter per page (paper §6.2 green line); sizes from the phase."""
    n = min(len(phase.sizes), g_max)
    sizes = np.asarray(phase.sizes[:n], np.float64)
    rate = 2.0 ** np.arange(n)
    agg = sizes * rate
    assumed_p = np.zeros(g_max, np.float32)
    assumed_p[:n] = agg / agg.sum()
    fdp_rate = np.zeros(g_max, np.float32)
    fdp_rate[:n] = (assumed_p[:n] / sizes).astype(np.float32)
    return assumed_p, fdp_rate


def build_drive(
    geom: Geometry,
    mcfg: ManagerConfig,
    phases: list[Phase],
    *,
    init_p_from_phase: bool = True,
    g_max: int | None = None,
    device="cuda",
):
    """Pre-conditioned drive state on ``device`` for a phase sequence.

    ``g_max`` pads the per-group arrays beyond ``mcfg.max_groups`` so that
    drives with different group caps share one batch's shapes (the bloom
    filter's width scales with 1/``g_max`` then).

    Returns (st, n_groups, assumed_p [G], fdp_rate [G], page_rates [P, LBA]
    — the true per-page update rate of every phase, the FDP detector's
    input — and page_group0 [LBA], the layout group of every logical page,
    where a write that re-maps a TRIMMED page lands), as the JAX package's.
    """
    # the drive's OWN cap decides whether pages are separated at all;
    # g_max only pads the per-group arrays
    first = phases[0]
    n_groups = 1 if mcfg.max_groups == 1 else len(first.sizes)
    if g_max is not None and g_max != mcfg.max_groups:
        mcfg = dataclasses.replace(mcfg, max_groups=g_max)
    g_max = mcfg.max_groups
    page_group = (
        np.zeros(geom.lba_pages, np.int32)
        if n_groups == 1
        else first.page_group()
    )
    st = init_state(
        geom, mcfg, page_group, n_groups,
        use_bloom=mcfg.td_mode == "bloom", device=device,
    )
    if init_p_from_phase and n_groups > 1:
        p0 = np.zeros(g_max, np.float32)
        p0[: len(first.probs)] = first.probs
        st.grp_p.copy_(st.grp_p.new_tensor(p0))
    assumed_p, fdp_rate = fdp_assumed_arrays(first, g_max)
    uniform_rate = np.full(geom.lba_pages, 1.0 / geom.lba_pages, np.float32)
    page_rates = np.stack([
        phase.page_rate() if n_groups > 1 else uniform_rate
        for phase in phases
    ])
    return st, n_groups, assumed_p, fdp_rate, page_rates, page_group


def simulate(
    geom: Geometry,
    mcfg: ManagerConfig,
    phases: list[Phase],
    *,
    seed: int = 0,
    init_p_from_phase: bool = True,
    gc_impl: str = "bulk",
    fast_path: bool = True,
    trace_every: int = 1,
    ops_stream: bool | None = None,
    faults: bool | None = None,
    device="cuda",
) -> RunResult:
    """Run a (possibly multi-phase) workload under a manager preset on
    ``device``; the same seed draws the same stream as the JAX package's
    ``managers.simulate``.

    gc_impl: "bulk" (the drive's victim at once, default) or "reference"
    (page by page, the oracle); fast_path: False steps every event
    through the reference step. Every pair gives the same run.

    ops_stream: None routes through the op-stream engine iff a phase
    carries TRIMs; True forces it for pure-write phases too (the sampled
    events are then the same, and so is the run). Each phase's run reads
    that phase's page rates (the FDP detector's oracle input).

    faults: None runs the fault layer iff ``mcfg.has_faults``; True runs
    it for a configuration that cannot fail as well (every erase then
    draws and none fails, so only ``fault_draws`` differs from the
    fault-free run); False is refused for a configuration that can fail.
    """
    if faults is None:
        faults = mcfg.has_faults
    if mcfg.has_faults and not faults:
        raise ValueError("the configuration can fail erases: faults=False "
                         "is not available")
    has_trim = any(ph.has_trim for ph in phases)
    if ops_stream is None:
        ops_stream = has_trim
    if has_trim and not ops_stream:
        raise ValueError(
            "phases carry TRIMs: ops_stream=False is not available")
    rng = np.random.default_rng(seed)
    st, n_groups, assumed_p, fdp_rate, page_rates, page_group0 = build_drive(
        geom, mcfg, phases, init_p_from_phase=init_p_from_phase,
        device=device,
    )
    ctx = SimContext(geom, mcfg, n_groups, trace_every=trace_every,
                     with_trim=ops_stream, with_faults=faults,
                     gc_impl=gc_impl, fast_path=fast_path)
    apps, migs, syncs = [], [], 0
    for phase, page_rate in zip(phases, page_rates):
        if ops_stream:
            ops, lbas = phase.sample_ops(rng)
            kw = dict(ops=ops, page_group0=page_group0)
        else:
            lbas, kw = phase.sample(rng), {}
        st, trace = run(ctx, st, lbas, page_rate=page_rate,
                        assumed_p=assumed_p, fdp_rate=fdp_rate,
                        device=device, **kw)
        apps.append(trace["app"])
        migs.append(trace["mig"])
        syncs += trace["host_syncs"]
    return RunResult(
        np.concatenate(apps), np.concatenate(migs), st,
        stride=trace_every, host_syncs=syncs,
    )
