"""Fleet-scale batched SSD simulation on one device: D drives run in
lock-step through the simulator's batched path.

The counterpart of ``repro.core.fleet`` for one card. A fleet stacks the
drives' states on a leading drive axis and runs each sub-batch through
``simulator.scan_writes``: one ``write_run`` launch a round lands every
drive's run of fast events, one read of the D stops decides the round, and
the heavy tail runs once for the drives that stopped, masked per drive
(``core/simulator.py``). Per-drive differences — workload, seed, FDP
assumption arrays, victim-score weights, allocation mode, EWMA constant and
group cap — are per-drive policy rows, so wolf, fdp and single-group drives
of one step structure share a sub-batch.

Sub-batches: drives are split by step STRUCTURE, :func:`_part_key` —
detector, movement operations, dynamic groups, closed-form allocation, op
stream — and by the §5.1 interval length h, which the run kernel takes as
one number for all its drives (the drives are independent, so the split
changes no result). Group arrays are padded to the sub-batch's largest
group cap (each drive keeps its own cap for §5.2 creation); the bloom
filter's width scales with 1/cap, so the pad is per sub-batch, as in the
JAX package.

Phases: a drive's phases cut its events; the fleet cuts its events at the
union of every drive's phase boundaries and hands each segment each
drive's current page rates ([D, LBA], the FDP detector's oracle input).

Samplers: "numpy" draws exactly the streams ``managers.simulate`` draws
for the same (phases, seed), so a fleet equals its drives run alone;
"device" (the default) draws each drive's stream on the fleet's device
from a ``torch.Generator`` seeded by the drive's seed alone
(``workloads.sample_phases_device``): the same distribution, another
stream.

Faults: the fault rates, endurance limit and seed are per-drive policy,
not a sub-batch key: a sub-batch runs the fault layer when any of its
drives can fail an erase, and its fault-free drives then run as they
would alone but for ``fault_draws``. A degraded drive is an inert lane:
``write_run`` lands each of its later events as a halted no-op to the
segment's end, so it never stops a run, never enters a round's mask or a
``gc_one`` enable, and no §5.1 hold waits for it. ``FleetResult`` reports
``drive_status``, ``retired_fraction`` and ``time_to_degraded``.

Engines: ``gc_impl`` and ``fast_path`` choose the drain and the step as
for one drive (``managers.simulate``): the reference drain and the
reference step (every event in lock-step over the D drives, masked per
drive) are the oracles, and every pair gives the same results. The JAX
package's fleet steps the reference step by default, because under
``vmap`` a ``lax.cond`` runs both branches and the split step's lean
branch is extra work there; here the split step's runs are the fast
path, so ``fast_path=True`` stays the default.

Devices: ``devices=`` splits the drives into contiguous slices, one a
card (``resolve_devices``: None or 1 is ``device`` alone, "auto" every
visible card, an int that many, clamped to what the host has, or an
explicit list), runs each slice as a fleet of its own, one after another
from this thread, and joins the results in drive order. Drives are
independent lanes, so the results are those of one device. The JAX
package's compile caches and its padding of ragged sub-batches to the
mesh have no counterpart: a slice is a fleet of any size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import simulator
from repro_torch.core.allocation import total_wa
from repro_torch.core.analytics import (
    dwpd_from_lifetime,
    lifetime_host_writes,
    retired_fraction,
    wa_vs_lifetime,
    wear_imbalance,
    wear_variance,
)
from repro_torch.core.managers import RunResult, build_drive
from repro_torch.core.simulator import (
    CLOSED_FORM_MODES,
    SimContext,
    policy_from_config,
    stack_policies,
)
from repro_torch.core.ssd import (
    Geometry,
    ManagerConfig,
    SimState,
    stack_states,
)
from repro_torch.core.workloads import (
    Phase,
    phase_param_arrays,
    sample_phases_device,
)
from repro_torch.utils.spans import span

# ManagerConfig fields that must agree fleet-wide: the paper's constants,
# which a sub-batch's context holds once. interval_frac and ewma_a are not
# here: ewma_a is per-drive policy, and the interval length splits
# sub-batches.
_SHARED_FIELDS = (
    "q_create", "w_intervals",
    "cold_hit_rate_frac", "cold_op_frac", "gc_reserve_blocks",
    "bloom_bits_per_page", "valve_max_tries", "bloom_rotate_min_writes",
    "erase_max_retries",
)


# the ManagerConfig fields that are per-drive fault policy only (the state
# a drive starts from does not read them), at their fault-free values
_FAULT_POLICY_KNOBS = dict(fault_rate=0.0, fault_rate_worn=1.0,
                           endurance_pe_limit=0, fault_seed=0)


@dataclasses.dataclass(frozen=True)
class DriveSpec:
    """One drive of a fleet: a manager preset over a phase sequence."""

    mcfg: ManagerConfig
    phases: tuple[Phase, ...]
    seed: int = 0
    name: str | None = None

    @property
    def label(self) -> str:
        return self.name or f"{self.mcfg.name}#{self.seed}"


@dataclasses.dataclass
class FleetResult:
    app: np.ndarray  # [B, T // trace_every] cumulative application writes
    mig: np.ndarray  # [B, T // trace_every] cumulative migrations
    specs: list[DriveSpec]
    # (original drive indices, the sub-batch's stacked SimState) each
    shards: list[tuple[list[int], SimState]]
    lbas: np.ndarray | None = None  # [B, T] when return_lbas=True
    geom: Geometry | None = None  # shared fleet geometry (analytics)
    trace_every: int = 1  # trace stride (RunResult.stride of every drive)
    # per sub-batch: its drives, rounds (write_run launches), interval
    # batches (rounds that completed §5.1 intervals), host syncs, the
    # interval length h, the fleet's device count and (split over several
    # devices) the index of the slice it ran in
    exec_meta: list[dict] = dataclasses.field(default_factory=list)

    @property
    def devices_used(self) -> int:
        """How many devices the fleet was split over."""
        return max((m["devices"] for m in self.exec_meta), default=1)

    def state(self, i: int) -> SimState:
        """Final state of drive i (views into its sub-batch's)."""
        for idx, states in self.shards:
            if i in idx:
                return states.drive(idx.index(i))
        raise IndexError(i)

    @property
    def states(self) -> SimState:
        """The stacked states, for a fleet of one sub-batch only."""
        if len(self.shards) != 1:
            raise ValueError("a fleet of several sub-batches: use .state(i)")
        return self.shards[0][1]

    def result(self, i: int) -> RunResult:
        """Per-drive view with the single-drive RunResult API."""
        return RunResult(
            self.app[i], self.mig[i], self.state(i), stride=self.trace_every
        )

    @property
    def wa_total(self) -> np.ndarray:
        """[B] end-to-end write amplification per drive."""
        return (self.app[:, -1] + self.mig[:, -1]) / np.maximum(
            self.app[:, -1], 1
        )

    def wa_curves(self, window: int = 2000) -> np.ndarray:
        """[B, K] windowed WA over time per drive."""
        return np.stack(
            [self.result(i).wa_curve(window) for i in range(len(self.specs))]
        )

    # -- closed-form analytics (paper eq. 3/5 + effective OP) ---------------

    def _geom(self) -> Geometry:
        if self.geom is None:
            raise ValueError("fleet built without geometry")
        return self.geom

    def trim_fraction(self) -> np.ndarray:
        """[B] fraction of the logical span each drive holds TRIMMED at its
        final state, from the carried ``mapped_pages`` counter."""
        lba = self._geom().lba_pages
        return np.array([
            1.0 - float(self.state(i).mapped_pages) / lba
            for i in range(len(self.specs))
        ])

    def predicted_wa(self) -> np.ndarray:
        """[B] closed-form model WA per drive at its final operating point:
        each active group a uniform sub-SSD of effective size ``grp_live``
        with over-provisioning ``grp_alloc·B − grp_live`` (eq. 4), the
        drive's WA their sum weighted by the measured EWMA frequencies
        (eq. 5; by size before any interval completed)."""
        b = self._geom().pages_per_block
        out = np.zeros(len(self.specs))
        for i in range(len(self.specs)):
            st = self.state(i)
            active = st.grp_active.cpu().numpy()
            s = st.grp_live.cpu().numpy().astype(np.float64)
            op_x = st.grp_alloc.cpu().numpy().astype(np.float64) * b - s
            p = np.where(active, st.grp_p.cpu().numpy().astype(np.float64),
                         0.0)
            if p.sum() <= 0.0:
                p = np.where(active, s, 0.0)
            p = p / max(p.sum(), 1e-12)
            s_safe = np.where(active & (s > 0), s, 1.0)
            out[i] = float(total_wa(
                torch.as_tensor(s_safe, dtype=torch.float32),
                torch.as_tensor(p, dtype=torch.float32),
                torch.as_tensor(np.maximum(op_x, 0.0), dtype=torch.float32),
            ))
        return out

    # -- wear / endurance analytics (per-block P-E counts) ------------------

    def wear_variance(self) -> np.ndarray:
        """[B] population variance of per-block erase counts, from the
        carried aggregates."""
        k = self._geom().n_blocks
        return np.array([
            float(wear_variance(self.state(i).erase_total.cpu(),
                                self.state(i).erase_sq_total.cpu(), k))
            for i in range(len(self.specs))
        ])

    def wear_imbalance(self) -> np.ndarray:
        """[B] max/mean P-E ratio per drive (1.0 = perfectly level)."""
        return np.array([
            float(wear_imbalance(self.state(i).erase_count.cpu()))
            for i in range(len(self.specs))
        ])

    def lifetime_dwpd(self, *, pe_cycles: float = 3000.0,
                      years: float = 5.0) -> np.ndarray:
        """[B] sustainable drive-writes-per-day over a warranty window,
        projecting each drive's measured WA and wear imbalance onto a NAND
        P-E budget (default 3k cycles)."""
        geom = self._geom()
        host = lifetime_host_writes(
            n_blocks=geom.n_blocks, pages_per_block=geom.pages_per_block,
            pe_cycles=pe_cycles,
            wa=torch.as_tensor(self.wa_total, dtype=torch.float32),
            imbalance=torch.as_tensor(self.wear_imbalance(),
                                      dtype=torch.float32),
        )
        return dwpd_from_lifetime(host, lba_pages=geom.lba_pages,
                                  years=years).numpy()

    def wa_vs_lifetime(self, window: int = 2000) -> np.ndarray:
        """[B, K] windowed WA over each drive's lifetime, NaN for a window
        that completes no application write."""
        return np.stack([
            wa_vs_lifetime(self.app[i], self.mig[i], window=window,
                           stride=self.trace_every)
            for i in range(len(self.specs))
        ])

    # -- survival analytics (fault injection) -------------------------------

    def drive_status(self) -> np.ndarray:
        """[B] each drive's status at the end: 0 = STATUS_OK, 1 =
        STATUS_DEGRADED (spares exhausted or pool death; the drive halted)."""
        return np.array([int(self.state(i).drive_status)
                         for i in range(len(self.specs))])

    def retired_fraction(self) -> np.ndarray:
        """[B] fraction of each drive's physical blocks RETIRED (0.0 for a
        drive that cannot fail), float32 as the JAX package computes it."""
        k = self._geom().n_blocks
        return np.array([
            float(retired_fraction(self.state(i).retired_blocks.cpu(), k))
            for i in range(len(self.specs))
        ])

    def time_to_degraded(self) -> np.ndarray:
        """[B] the application write at which each drive degraded, -1 for
        a drive still in service at the end (``analytics.survival_fraction``
        turns it into a survival curve)."""
        return np.array([int(self.state(i).degraded_at)
                         for i in range(len(self.specs))])

    def model_error(self, window: int = 2000, tail: int = 3,
                    pred: np.ndarray | None = None) -> np.ndarray:
        """[B] relative error of the eq. 3/5 prediction against the
        simulated equilibrium WA (the mean of the last ``tail`` windows of
        each drive). ``pred``: a :meth:`predicted_wa` already computed."""
        if pred is None:
            pred = self.predicted_wa()
        measured = np.array([
            float(np.mean(self.result(i).wa_curve(window)[-tail:]))
            for i in range(len(self.specs))
        ])
        return (pred - measured) / np.maximum(measured, 1e-12)


def _spec_has_trim(s: DriveSpec) -> bool:
    return any(ph.has_trim for ph in s.phases)


def _part_key(s: DriveSpec) -> tuple[str, bool, bool, bool, bool]:
    """Sub-batch key: the step STRUCTURE a drive's heavy path carries —
    detector, movement operations, dynamic groups, closed-form allocation,
    op stream — as the JAX package keys its sub-batches. Every sub-batch
    is then one detector and one op mode (what ``write_run`` takes as one
    value), and drives that never use the bloom filter pair, the §5.6
    demoting drain, movement operations or §5.2 carry none of them."""
    return (
        s.mcfg.td_mode,
        s.mcfg.movement_ops,
        s.mcfg.dynamic_groups,
        s.mcfg.alloc_mode in CLOSED_FORM_MODES,
        _spec_has_trim(s),
    )


def _interval_len(geom: Geometry, mcfg: ManagerConfig) -> int:
    return SimContext(geom, mcfg, 1).h


def _check(geom, specs, *, sampler, trace_every, ops_stream):
    if not specs:
        raise ValueError("empty fleet")
    if sampler not in ("device", "numpy"):
        raise ValueError(f"unknown sampler {sampler!r}")
    if ops_stream is False and any(_spec_has_trim(s) for s in specs):
        raise ValueError(
            "specs carry TRIMs: ops_stream=False is not available")
    totals = {sum(ph.n_writes for ph in s.phases) for s in specs}
    if len(totals) != 1:
        raise ValueError(f"drives must issue equal event totals: {totals}")
    n_total = totals.pop()
    if n_total % trace_every:
        raise ValueError(f"trace_every={trace_every} must divide {n_total}")
    base = specs[0].mcfg
    for s in specs:
        for f in _SHARED_FIELDS:
            if getattr(s.mcfg, f) != getattr(base, f):
                raise ValueError(
                    f"fleet drives must share ManagerConfig.{f} (a paper "
                    "constant)")
    return n_total


def _streams(sub, geom, n_total, *, sampler, with_trim, device):
    """The sub-batch's events: lbas [D, n] int64 on ``device`` and ops
    [D, n] int32 numpy (None without an op stream)."""
    if sampler == "numpy":
        lbas, ops = [], []
        for s in sub:
            rng = np.random.default_rng(s.seed)
            if with_trim:  # pure-write phases consume Phase.sample's draws
                pairs = [ph.sample_ops(rng) for ph in s.phases]
                ops.append(np.concatenate([o for o, _ in pairs]))
                lbas.append(np.concatenate([lb for _, lb in pairs]))
            else:
                lbas.append(np.concatenate(
                    [ph.sample(rng) for ph in s.phases]))
        return (torch.as_tensor(np.stack(lbas).astype(np.int64),
                                device=device),
                np.stack(ops) if with_trim else None)
    p_max = max(len(s.phases) for s in sub)
    g_wl = max(len(ph.sizes) for s in sub for ph in s.phases)
    lbas = torch.empty((len(sub), n_total), dtype=torch.int64, device=device)
    ops = np.zeros((len(sub), n_total), np.int32) if with_trim else None
    for d, s in enumerate(sub):
        params = phase_param_arrays(list(s.phases), g_max=g_wl, p_max=p_max)
        gen = torch.Generator(device=device).manual_seed(s.seed)
        drawn = sample_phases_device(gen, params, n_total,
                                     with_ops=with_trim)
        if with_trim:
            ops[d] = drawn[0].cpu().numpy()
            drawn = drawn[1]
        lbas[d] = drawn
    return lbas, ops


def resolve_devices(devices=None, device="cuda") -> list[torch.device]:
    """The devices a fleet is split over, as the JAX package resolves
    ``simulate_fleet``'s ``devices=`` (repro/core/fleet_exec.py:102):
    None or 1 is ``device`` alone; "auto" every visible device of its type
    (every card, or the one CPU); an int (or numeric string) that many,
    clamped to the visible count and at least 1; a list or tuple names
    them."""
    if isinstance(devices, (list, tuple)):
        if not devices:
            raise ValueError("devices: an empty list")
        return [torch.device(d) for d in devices]
    base = torch.device(device)
    if devices in (None, 1):
        return [base]
    cards = torch.cuda.device_count() if base.type == "cuda" else 0
    n_avail = max(cards, 1)
    n = n_avail if devices == "auto" else max(1, min(int(devices), n_avail))
    if base.type != "cuda":
        return [base] * n
    return [torch.device("cuda", i) for i in range(n)]


def simulate_fleet(
    geom: Geometry,
    specs: list[DriveSpec],
    *,
    sampler: str = "device",
    init_p_from_phase: bool = True,
    return_lbas: bool = False,
    gc_impl: str = "bulk",
    fast_path: bool = True,
    trace_every: int = 1,
    ops_stream: bool | None = None,
    device="cuda",
    devices=None,
) -> FleetResult:
    """Run the drives ``specs`` in lock-step on ``device``.

    sampler: "device" draws every stream on the device (see the module
    docstring); "numpy" replays the exact host streams ``managers.simulate``
    draws for the same (phases, seed), and then each drive's trace and
    final state equal its run alone.

    ops_stream: None routes a drive through the op-stream engine iff its
    phases carry TRIMs (the sub-batch key separates them); True forces
    every drive through it (with the numpy sampler the events are then the
    same on pure-write phases, and so is the run).

    gc_impl / fast_path: the drain and the step engine (see the module
    docstring), a scheduling choice: the results are the same.

    trace_every must divide the event total and every segment between
    phase boundaries; app/mig come back [B, n_total // trace_every].
    Every spec must issue the same number of events.

    devices: see ``resolve_devices``; with more than one, contiguous
    slices of the drives, one a device (see the module docstring).
    """
    with span("fleet.simulate"):
        n_total = _check(geom, specs, sampler=sampler,
                         trace_every=trace_every, ops_stream=ops_stream)
        devs = resolve_devices(devices, device)
        n_dev = min(len(devs), len(specs))
        if n_dev > 1:
            return _sliced(geom, specs, devs[:n_dev], sampler=sampler,
                           init_p_from_phase=init_p_from_phase,
                           return_lbas=return_lbas, gc_impl=gc_impl,
                           fast_path=fast_path, trace_every=trace_every,
                           ops_stream=ops_stream)
        device = devs[0]

        def key(s: DriveSpec):
            k = _part_key(s)
            if ops_stream:  # every drive on the op-stream engine
                k = k[:-1] + (True,)
            return k + (_interval_len(geom, s.mcfg),)

        n_trace = n_total // trace_every
        app = np.zeros((len(specs), n_trace), np.int32)
        mig = np.zeros((len(specs), n_trace), np.int32)
        lbas_out = (np.zeros((len(specs), n_total), np.int32)
                    if return_lbas else None)
        shards, exec_meta = [], []
        for part in sorted({key(s) for s in specs}):
            idx = [i for i, s in enumerate(specs) if key(s) == part]
            sub = [specs[i] for i in idx]
            with_trim = part[4]
            with span("fleet.build"):
                st, ctx, policy, rates = _build(geom, sub, init_p_from_phase,
                                                trace_every, with_trim, device)
            ctx = dataclasses.replace(ctx, gc_impl=gc_impl,
                                      fast_path=fast_path)
            with span("fleet.streams"):
                lbas, ops = _streams(sub, geom, n_total, sampler=sampler,
                                     with_trim=with_trim, device=device)
            if return_lbas:
                with span("fleet.readback"):
                    lbas_out[idx] = lbas.cpu().numpy()
            counts = (simulator.rounds, simulator.interval_batches,
                      simulator.host_syncs)
            sub_app, sub_mig = _run_segments(ctx, st, lbas, ops, policy,
                                             rates, sub, trace_every)
            app[idx], mig[idx] = sub_app, sub_mig
            shards.append((idx, st))
            exec_meta.append({
                "drives": len(sub),
                "rounds": simulator.rounds - counts[0],
                "interval_batches": simulator.interval_batches - counts[1],
                "host_syncs": simulator.host_syncs - counts[2],
                "h": ctx.h,
                "devices": 1,
            })
        return FleetResult(
            app=app, mig=mig, specs=list(specs), shards=shards,
            lbas=lbas_out, geom=geom, trace_every=trace_every,
            exec_meta=exec_meta,
        )


def _sliced(geom, specs, devs, **kw) -> FleetResult:
    """The fleet as contiguous slices of its drives, one a device, run
    one after another and joined in drive order."""
    bounds = np.linspace(0, len(specs), len(devs) + 1).round().astype(int)
    parts = []
    for k, dev in enumerate(devs):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        parts.append((lo, simulate_fleet(geom, specs[lo:hi], device=dev,
                                         **kw)))
    shards, exec_meta = [], []
    for k, (lo, part) in enumerate(parts):
        shards += [([lo + i for i in idx], st) for idx, st in part.shards]
        exec_meta += [dict(m, slice=k, devices=len(devs))
                      for m in part.exec_meta]
    lbas = [p.lbas for _, p in parts]
    return FleetResult(
        app=np.concatenate([p.app for _, p in parts]),
        mig=np.concatenate([p.mig for _, p in parts]),
        specs=list(specs), shards=shards,
        lbas=None if lbas[0] is None else np.concatenate(lbas),
        geom=geom, trace_every=kw["trace_every"], exec_meta=exec_meta,
    )


def _build(geom, sub, init_p_from_phase, trace_every, with_trim, device):
    """The sub-batch's stacked state, context, stacked policy, and each
    drive's page rates per phase ([P, LBA] numpy)."""
    g_max = max(s.mcfg.max_groups for s in sub)
    # the fault layer runs for the whole sub-batch when any drive can fail
    with_faults = any(s.mcfg.has_faults for s in sub)
    # drives alike but for their seed share one build of the state, and
    # but for their fault policy too (it is no part of the state)
    built, made = {}, {}
    states, policies, rates = [], [], []
    n_groups_max = 1
    for s in sub:
        pre = (dataclasses.replace(s.mcfg, **_FAULT_POLICY_KNOBS),
               tuple(s.phases))
        if pre not in built:
            built[pre] = build_drive(
                geom, s.mcfg, list(s.phases),
                init_p_from_phase=init_p_from_phase, g_max=g_max,
                device=device)
        st, n_groups, assumed_p, fdp_rate, page_rates, pg0 = built[pre]
        if (s.mcfg, pre) not in made:
            ctx_d = SimContext(
                geom, dataclasses.replace(s.mcfg, max_groups=g_max),
                n_groups, with_trim=with_trim, with_faults=with_faults)
            policy = policy_from_config(
                ctx_d, device, assumed_p=assumed_p, fdp_rate=fdp_rate,
                page_group0=pg0 if with_trim else None)
            # the drive keeps its OWN group cap inside the padded arrays
            policy["max_groups"].fill_(s.mcfg.max_groups)
            made[s.mcfg, pre] = policy
        n_groups_max = max(n_groups_max, n_groups)
        states.append(st)
        policies.append(made[s.mcfg, pre])
        rates.append(page_rates)
    stacked = stack_states(states)
    ctx = SimContext(
        geom, dataclasses.replace(sub[0].mcfg, name="fleet", max_groups=g_max),
        n_groups_max, trace_every=trace_every, with_trim=with_trim,
        with_faults=with_faults)
    return stacked, ctx, stack_policies(policies), rates


def _run_segments(ctx, st, lbas, ops, policy, rates, sub, trace_every):
    """Run the sub-batch's events, cut at the union of its drives' phase
    boundaries, each segment with each drive's current page rates; returns
    the traces (app, mig) [D, n // trace_every] numpy."""
    n_drives, n_total = lbas.shape
    ends = [np.cumsum([ph.n_writes for ph in s.phases]) for s in sub]
    cuts = sorted({0, n_total, *(int(c) for e in ends for c in e)})
    app = np.zeros((n_drives, n_total // trace_every), np.int32)
    mig = np.zeros_like(app)
    w = np.zeros(n_drives, np.int64)
    dev = st.device
    on_device = {}  # (drive's rates, phase) -> the row on the device
    for a, b in zip(cuts[:-1], cuts[1:]):
        if (b - a) % trace_every:
            raise ValueError(
                f"trace_every={trace_every} must divide the segment "
                f"[{a}, {b}) between phase boundaries")
        page_rate = torch.empty((n_drives, rates[0].shape[1]),
                                dtype=torch.float32, device=dev)
        for d in range(n_drives):
            p = int(np.searchsorted(ends[d], a, side="right"))
            row = (id(rates[d]), p)
            if row not in on_device:
                on_device[row] = torch.as_tensor(rates[d][p], device=dev)
            page_rate[d] = on_device[row]
        seg_ops = None if ops is None else ops[:, a:b]
        seg_app, seg_mig = simulator.scan_writes(
            ctx, st, lbas[:, a:b].contiguous(), w,
            {**policy, "page_rate": page_rate}, seg_ops)
        with span("fleet.readback"):
            app[:, a // trace_every: b // trace_every] = seg_app.cpu().numpy()
            mig[:, a // trace_every: b // trace_every] = seg_mig.cpu().numpy()
        w = w + (b - a if ops is None
                 else (seg_ops != simulator.OP_TRIM).sum(1))
    return app, mig
