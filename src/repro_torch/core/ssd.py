"""SSD geometry + simulator state (paper §3 system model), in PyTorch.

The counterpart of ``repro.core.ssd``. The simulator is
write-amplification-faithful, not timing-faithful: every figure of the
paper reports WA (migrations per application write).

State is a :class:`SimState`: a frozen dataclass of tensors that all live on
one device. Fields are never rebound; the simulator updates the tensors in
place (what the JAX package expresses as functional ``replace`` calls and
Pallas ``input_output_aliases``). The logical→physical mapping is ONE packed
int32 tensor (``page_map``, ``blk * pages_per_block + slot``, ``-1`` =
unmapped).
"""

from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np
import torch

FREE, OPEN, CLOSED = 0, 1, 2
# terminal block state of the fault layer: a block whose erase failed
# every retry, out of circulation for good
RETIRED = 3
STATUS_OK, STATUS_DEGRADED = 0, 1
INT32_MAX = 2**31 - 1


def surplus_of(grp_active, grp_phys, grp_alloc):
    """Masked per-group block surplus (the carried ``SimState.grp_surplus``):
    ``grp_phys - grp_alloc`` where active, ``-INT32_MAX`` elsewhere so the
    movement-op argmax never picks an inactive group."""
    return torch.where(
        grp_active, grp_phys - grp_alloc, -INT32_MAX
    ).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Physical geometry. Defaults: a scaled-down Table-2 SSD (ratios kept)."""

    n_luns: int = 8
    blocks_per_lun: int = 64
    pages_per_block: int = 16
    lba_pba: float = 0.70

    @property
    def n_blocks(self) -> int:
        return self.n_luns * self.blocks_per_lun

    @property
    def pba_pages(self) -> int:
        return self.n_blocks * self.pages_per_block

    @property
    def lba_pages(self) -> int:
        return int(self.pba_pages * self.lba_pba)

    @property
    def op_pages(self) -> int:
        return self.pba_pages - self.lba_pages


# (α, β, γ, τ) victim-score weight points per gc_policy preset
GC_WEIGHT_PRESETS = {
    "greedy": (1.0, 0.0, 0.0, 0.0),
    "lru": (0.0, 0.0, 1.0, 0.0),
    "wear": (1.0, 0.25, 0.0, 0.0),
    "trim_aware": (1.0, 0.0, 0.0, 1.0),
}


@dataclasses.dataclass(frozen=True)
class ManagerConfig:
    """Block-manager policy knobs (field for field the JAX package's).

    Presets in :mod:`repro_torch.core.managers`. The fault knobs (the
    per-erase failure rates, the P-E endurance limit, the retry budget,
    the spare pool and the fault stream's seed) are the JAX package's;
    :attr:`has_faults` says whether a configuration can fail an erase.
    """

    name: str = "wolf"
    max_groups: int = 8
    alloc_mode: str = "wolf"
    gc_policy: str = "greedy"
    # victim-score weights S = α·(B − live) − γ·stamp − β·erase_count −
    # τ·trim_dead; None takes the component from the gc_policy preset
    gc_alpha: float | None = None
    gc_beta: float | None = None
    gc_gamma: float | None = None
    gc_trim_penalty: float | None = None
    movement_ops: bool = True
    td_mode: str = "static"
    dynamic_groups: bool = False
    interval_frac: float = 0.001  # h = LBA · 0.001
    ewma_a: float = 0.3
    q_create: float = 2.0
    w_intervals: int = 50
    cold_hit_rate_frac: float = 0.05
    cold_op_frac: float = 0.05
    gc_reserve_blocks: int = 2
    bloom_bits_per_page: int = 4
    valve_max_tries: int = 4
    bloom_rotate_min_writes: int = 64
    fault_rate: float = 0.0
    fault_rate_worn: float = 1.0
    endurance_pe_limit: int = 0
    erase_max_retries: int = 3
    spare_blocks: int | None = None
    fault_seed: int = 0

    @property
    def has_faults(self) -> bool:
        return self.fault_rate > 0.0 or (
            self.endurance_pe_limit > 0 and self.fault_rate_worn > 0.0
        )

    def gc_weights(self) -> tuple:
        """The victim-score weights (α, β, γ, τ): the ``gc_policy`` preset
        with any explicitly set ``gc_*`` component overriding it."""
        base = GC_WEIGHT_PRESETS[self.gc_policy]
        over = (self.gc_alpha, self.gc_beta, self.gc_gamma,
                self.gc_trim_penalty)
        return tuple(
            float(b if o is None else o) for b, o in zip(base, over)
        )


def bloom_bits(geom: Geometry, mcfg: ManagerConfig) -> int:
    """Bits per group-filter for the §5.6 bloom detector pair."""
    return max(
        64, geom.lba_pages * mcfg.bloom_bits_per_page // mcfg.max_groups
    )


# field name → dtype, in the JAX package's field order
SIM_STATE_DTYPES = {
    # page mapping (packed: blk * pages_per_block + slot, -1 = unmapped)
    "page_map": torch.int32,
    # block state
    "slot_lba": torch.int32, "valid": torch.bool, "live": torch.int32,
    "fill": torch.int32, "stamp": torch.int32, "state": torch.int8,
    "group_of": torch.int32,
    # wear / endurance
    "erase_count": torch.int32, "trim_dead": torch.int32,
    "erase_total": torch.int32, "erase_sq_total": torch.int32,
    # per-group
    "active_blk": torch.int32, "grp_size": torch.int32,
    "grp_phys": torch.int32, "grp_p": torch.float32,
    "grp_writes": torch.int32, "grp_alloc": torch.int32,
    "grp_active": torch.bool, "grp_created": torch.int32,
    "grp_surplus": torch.int32, "grp_live": torch.int32,
    # O(1) accounting
    "free_blocks": torch.int32, "mapped_pages": torch.int32,
    # fault / retirement layer
    "retired_blocks": torch.int32, "spares_left": torch.int32,
    "grp_retired": torch.int32, "drive_status": torch.int32,
    "degraded_at": torch.int32, "n_erase_fail": torch.int32,
    "n_halted": torch.int32, "fault_draws": torch.uint32,
    # detector (bloom filter pair)
    "bloom_active": torch.bool, "bloom_passive": torch.bool,
    "bloom_writes": torch.int32,
    # counters
    "n_app": torch.int32, "n_mig": torch.int32, "n_erase": torch.int32,
    "n_dropped": torch.int32, "n_trim": torch.int32, "clock": torch.int32,
    "interval": torch.int32, "cooldown": torch.int32,
}
SIM_STATE_FIELDS = tuple(SIM_STATE_DTYPES)
# the fields that are one value a drive (shape [], or [1] as the JAX
# package may hand a counter over)
COUNTER_FIELDS = (
    "erase_total", "erase_sq_total", "free_blocks", "mapped_pages",
    "retired_blocks", "spares_left", "drive_status", "degraded_at",
    "n_erase_fail", "n_halted", "fault_draws", "n_app", "n_mig", "n_erase",
    "n_dropped", "n_trim", "clock", "interval", "cooldown",
)


@dataclasses.dataclass(frozen=True)
class SimState:
    """Full drive state: a frozen bundle of tensors on one device.

    Shapes as in the JAX package: ``page_map [LBA]``, ``slot_lba``/``valid``
    ``[K, B]``, per-block ``[K]``, per-group ``[G]``, counters ``[]``,
    bloom pair ``[G, bits]`` (``[G, 1]`` when unused). The simulator mutates
    the tensors in place; mapping-style reads (``st["live"]``, ``items()``)
    serve analysis and test code.
    """

    page_map: torch.Tensor
    slot_lba: torch.Tensor
    valid: torch.Tensor
    live: torch.Tensor
    fill: torch.Tensor
    stamp: torch.Tensor
    state: torch.Tensor
    group_of: torch.Tensor
    erase_count: torch.Tensor
    trim_dead: torch.Tensor
    erase_total: torch.Tensor
    erase_sq_total: torch.Tensor
    active_blk: torch.Tensor
    grp_size: torch.Tensor
    grp_phys: torch.Tensor
    grp_p: torch.Tensor
    grp_writes: torch.Tensor
    grp_alloc: torch.Tensor
    grp_active: torch.Tensor
    grp_created: torch.Tensor
    grp_surplus: torch.Tensor
    grp_live: torch.Tensor
    free_blocks: torch.Tensor
    mapped_pages: torch.Tensor
    retired_blocks: torch.Tensor
    spares_left: torch.Tensor
    grp_retired: torch.Tensor
    drive_status: torch.Tensor
    degraded_at: torch.Tensor
    n_erase_fail: torch.Tensor
    n_halted: torch.Tensor
    fault_draws: torch.Tensor
    bloom_active: torch.Tensor
    bloom_passive: torch.Tensor
    bloom_writes: torch.Tensor
    n_app: torch.Tensor
    n_mig: torch.Tensor
    n_erase: torch.Tensor
    n_dropped: torch.Tensor
    n_trim: torch.Tensor
    clock: torch.Tensor
    interval: torch.Tensor
    cooldown: torch.Tensor

    def replace(self, **updates) -> "SimState":
        return dataclasses.replace(self, **updates)

    def __getitem__(self, key: str) -> torch.Tensor:
        return getattr(self, key)

    def keys(self):
        return iter(SIM_STATE_FIELDS)

    def items(self):
        return ((k, getattr(self, k)) for k in SIM_STATE_FIELDS)

    @property
    def device(self) -> torch.device:
        return self.page_map.device

    @property
    def is_batch(self) -> bool:
        """Whether this is a batch of drives: every field with a leading
        drive axis (``page_map [D, LBA]``, a counter ``[D]``)."""
        return self.page_map.dim() == 2

    @property
    def n_drives(self) -> int:
        """Drives in a batch; 1 for a drive."""
        return self.page_map.shape[0] if self.is_batch else 1

    @functools.cached_property
    def drive_axis(self) -> types.MappingProxyType:
        """Every field with a leading drive axis, the layout the batched
        kernels take, read-only: a drive's fields as views with an axis of
        1 (a counter as ``[1]``), a batch's fields as they are. Made once
        per state: the fields are never rebound, only updated in place, so
        a kernel may check and pack it once."""
        if self.is_batch:
            return types.MappingProxyType(dict(self.items()))
        return types.MappingProxyType({
            k: v.view(1) if k in COUNTER_FIELDS else v[None]
            for k, v in self.items()})

    @functools.cached_property
    def batch(self) -> "SimState":
        """This drive as a batch of one: its fields as views with a
        leading drive axis of 1 (what the simulator's heavy path takes),
        made once; a batch is its own."""
        if self.is_batch:
            return self
        return SimState(**self.drive_axis)

    def drive(self, d: int) -> "SimState":
        """Drive ``d`` of a batch, its fields as views into the batch's:
        an update of one updates the other, and no two drives' views
        share an element."""
        return SimState(**{k: v[d] for k, v in self.items()})

    def to(self, device) -> "SimState":
        """This state on ``device`` (itself when it is already there)."""
        if self.device == torch.device(device):
            return self
        return SimState(**{k: v.to(device) for k, v in self.items()})

    def check_invariants(self) -> dict:
        """Full-reduction cross-checks of the carried O(1)/O(G) accounting,
        as named 0-d bool tensors (see :func:`assert_invariants`)."""
        k, b = self.slot_lba.shape
        dev = self.device
        arange_g = torch.arange(self.grp_active.shape[0], device=dev)
        owned = self.group_of[None, :] == arange_g[:, None]  # [G, K]
        in_service = (self.state == OPEN) | (self.state == CLOSED)
        phys = (owned & in_service[None, :]).sum(1)
        owned_live = (owned * self.live[None, :]).sum(1)
        pm = self.page_map
        mapped = pm >= 0
        pm_c = torch.where(mapped, pm, k * b).long()
        hits = torch.bincount(pm_c, minlength=k * b + 1)
        at = pm_c.clamp(max=k * b - 1)
        back = torch.where(
            mapped,
            self.slot_lba.reshape(-1)[at]
            == torch.arange(pm.shape[0], device=dev),
            True,
        )
        slot_valid = torch.where(mapped, self.valid.reshape(-1)[at], True)
        ec = self.erase_count.long()
        return {
            "free_blocks": self.free_blocks == (self.state == FREE).sum(),
            "grp_phys": (phys == self.grp_phys).all(),
            "grp_surplus": (
                self.grp_surplus
                == surplus_of(self.grp_active, self.grp_phys, self.grp_alloc)
            ).all(),
            "grp_size": (owned_live == self.grp_size).all(),
            "grp_live": (owned_live == self.grp_live).all(),
            "mapped_pages": self.mapped_pages == mapped.sum(),
            "page_map_injective": (hits[: k * b] <= 1).all(),
            "page_map_valid": slot_valid.all(),
            "page_map_backptr": back.all(),
            "live_counts": (self.valid.sum(1) == self.live).all(),
            "fill_bounds": ((self.fill >= self.live) & (self.fill <= b)).all(),
            "erase_conservation": (self.erase_total == ec.sum())
            & (self.erase_total == self.n_erase),
            "erase_sq_total": self.erase_sq_total == (ec * ec).sum(),
            "erase_nonneg": (self.erase_count >= 0).all(),
            "trim_dead_bounds": (
                (self.trim_dead >= 0)
                & (self.trim_dead <= self.fill - self.live)
            ).all(),
            "trim_dead_pure_write": (self.n_trim > 0)
            | (self.trim_dead == 0).all(),
            "retired_blocks": self.retired_blocks
            == (self.state == RETIRED).sum(),
            "grp_retired": (
                (owned & (self.state == RETIRED)[None, :]).sum(1)
                == self.grp_retired
            ).all(),
            "spares_nonneg": self.spares_left >= 0,
            "degraded_consistent": (self.drive_status == STATUS_OK)
            | (self.degraded_at >= 0),
        }


def stack_states(states) -> SimState:
    """A batch of drives from drive states of one shape: every field
    copied into a new tensor with a leading drive axis, so no field of the
    batch shares storage with another or with the drives'."""
    return SimState(**{
        k: torch.stack([getattr(s, k) for s in states])
        for k in SIM_STATE_FIELDS})


def assert_invariants(st: SimState, label: str = "") -> None:
    """Host-side :meth:`SimState.check_invariants` with named failures."""
    failed = [k for k, ok in st.check_invariants().items() if not bool(ok)]
    if failed:
        where = f" ({label})" if label else ""
        raise AssertionError(f"invariants violated{where}: {failed}")


def _layout(page_group: np.ndarray, b: int, k: int):
    """Group-contiguous pre-conditioned layout, equal to the JAX package's
    per-page loop (ssd.py ``init_state``) but placed group by group.

    That loop opens a new block at a group boundary only when the current
    block is partly filled, and only then records the new group as current.
    A group that starts on a fresh block therefore places its first page
    alone and opens a new block for its second page. The per-page rule is
    replayed until the group is current; the rest of the group is placed in
    bulk.
    """
    lba = page_group.shape[0]
    order = np.argsort(page_group, kind="stable")
    page_map = np.full(lba, -1, np.int32)
    slot_lba = np.full(k * b, -1, np.int32)
    group_of = np.full(k, -1, np.int32)
    blk = slot = 0
    prev_g = int(page_group[order[0]])
    groups, starts = np.unique(page_group[order], return_index=True)
    ends = np.append(starts[1:], lba)
    for g, lo, hi in zip(groups.tolist(), starts.tolist(), ends.tolist()):
        i = lo
        while i < hi and g != prev_g:  # the per-page rule, ≤ 2 pages
            if slot > 0:
                blk, slot, prev_g = blk + 1, 0, g
            if slot == 0:
                group_of[blk] = g
            page_map[order[i]] = blk * b + slot
            slot_lba[blk * b + slot] = order[i]
            slot += 1
            if slot == b:
                blk, slot = blk + 1, 0
            i += 1
        n = hi - i
        if n == 0:
            continue
        pos = blk * b + slot + np.arange(n)
        page_map[order[i:hi]] = pos
        slot_lba[pos] = order[i:hi]
        group_of[pos[0] // b: pos[-1] // b + 1] = g
        end = pos[-1] + 1
        blk, slot = end // b, end % b
    if slot > 0:
        blk += 1
    return page_map, slot_lba.reshape(k, b), group_of, blk


def init_state(
    geom: Geometry,
    mcfg: ManagerConfig,
    page_group,
    n_groups: int,
    use_bloom: bool = True,
    *,
    device="cuda",
) -> SimState:
    """Build a pre-conditioned (fully mapped) drive on ``device``.

    page_group: int array [LBA], the initial group of every logical page.
    Pages are laid out group-contiguously; leftover blocks are FREE.
    """
    k, b, lba = geom.n_blocks, geom.pages_per_block, geom.lba_pages
    g_max = mcfg.max_groups
    page_group = np.asarray(page_group, np.int32)
    if page_group.shape != (lba,):
        raise ValueError(f"page_group shape {page_group.shape} != ({lba},)")
    if not page_group.max() < n_groups <= g_max:
        raise ValueError(
            f"need max(page_group) < n_groups <= max_groups, got "
            f"{page_group.max()}, {n_groups}, {g_max}"
        )

    page_map, slot_lba, group_of, blk = _layout(page_group, b, k)
    valid = slot_lba >= 0
    live = valid.sum(1).astype(np.int32)
    fill = np.where(np.arange(k) < blk, b, 0).astype(np.int32)
    state_arr = np.where(np.arange(k) < blk, CLOSED, FREE).astype(np.int8)

    grp_size = np.bincount(page_group, minlength=g_max).astype(np.int32)
    grp_phys = np.bincount(
        group_of[group_of >= 0], minlength=g_max
    ).astype(np.int32)
    grp_active = np.arange(g_max) < n_groups
    grp_alloc = np.maximum(grp_phys, 1).astype(np.int32)

    content_blocks = -(-lba // b)  # ceil
    auto_spares = max(
        0, k - content_blocks - mcfg.gc_reserve_blocks - g_max - 2
    )
    spares = (
        auto_spares
        if mcfg.spare_blocks is None
        else max(0, min(mcfg.spare_blocks, auto_spares))
    )
    bits = bloom_bits(geom, mcfg) if use_bloom else 1

    def t(x, dtype):
        # a copy: two fields made from one array (grp_size, grp_live) must
        # not share storage, which torch.as_tensor gives them on the CPU
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    return SimState(
        page_map=t(page_map, i32),
        slot_lba=t(slot_lba, i32),
        valid=t(valid, torch.bool),
        live=t(live, i32),
        fill=t(fill, i32),
        # LRU ages: initially-filled blocks aged by layout order
        stamp=t(np.where(np.arange(k) < blk, np.arange(k), 0), i32),
        state=t(state_arr, torch.int8),
        group_of=t(group_of, i32),
        erase_count=z(k, i32),
        trim_dead=z(k, i32),
        erase_total=z((), i32),
        erase_sq_total=z((), i32),
        active_blk=t(np.full(g_max, -1), i32),
        grp_size=t(grp_size, i32),
        grp_phys=t(grp_phys, i32),
        grp_p=z(g_max, torch.float32),
        grp_writes=z(g_max, i32),
        grp_alloc=t(grp_alloc, i32),
        grp_active=t(grp_active, torch.bool),
        grp_created=z(g_max, i32),
        grp_surplus=t(
            np.where(grp_active, grp_phys - grp_alloc, -INT32_MAX), i32
        ),
        grp_live=t(grp_size, i32),  # fully mapped: live == size
        free_blocks=t(int((state_arr == FREE).sum()), i32),
        mapped_pages=t(lba, i32),
        retired_blocks=z((), i32),
        spares_left=t(spares, i32),
        grp_retired=z(g_max, i32),
        drive_status=t(STATUS_OK, i32),
        degraded_at=t(-1, i32),
        n_erase_fail=z((), i32),
        n_halted=z((), i32),
        fault_draws=z((), torch.uint32),
        bloom_active=z((g_max, bits), torch.bool),
        bloom_passive=z((g_max, bits), torch.bool),
        bloom_writes=z(g_max, i32),
        n_app=z((), i32),
        n_mig=z((), i32),
        n_erase=z((), i32),
        n_dropped=z((), i32),
        n_trim=z((), i32),
        clock=t(blk, i32),
        interval=z((), i32),
        cooldown=z((), i32),
    )
