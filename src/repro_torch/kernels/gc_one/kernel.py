"""ctypes binding of the GC kernel (``kernels/csrc/gc_one.cu``), which
chooses a GC's group and victim, decides it and, asked to drain (the bulk
drain: under the static detector every page back into its group, under
the FDP and bloom detectors with §5.6 demotion), drains the victim in one
launch (and, given a fault policy, passes the erase through the
retry-then-retire hook); a call that does not drain only decides: the
redesign, for the simulator's paths, of the Pallas TPU kernel
``compact_slots`` in ``repro/kernels/gc_compact/kernel.py`` together with
the JAX package's ``_gc_one`` around it."""

from __future__ import annotations

import ctypes
import types

import torch

from repro_torch.kernels import _build

# gc_one_cuda launches since the count was last set to 0 (one per call),
# and those among them that carried the demoting drain
launches = 0
demote_launches = 0

# how the group is chosen (Mode in gc_one.cu): the given g, enabled when it
# needs a block it is not entitled to or the pool is at reserve; the group
# of the CLOSED block with the fewest live pages (the emergency valve); the
# group of the largest block surplus (a movement operation)
MODES = ("gc", "valve", "movement")
TD_MODES = ("static", "fdp", "bloom")
MAX_GROUPS = 64   # the kernel's per-group loops
MAX_PAGES = 1024  # pages per block: one thread a slot

# SimState fields the kernel reads or writes, each with a leading drive axis
STATE_FIELDS = (
    "page_map", "slot_lba", "valid", "live", "fill", "stamp", "state",
    "group_of", "erase_count", "trim_dead", "erase_total", "erase_sq_total",
    "active_blk", "grp_phys", "grp_alloc", "grp_active", "grp_surplus",
    "grp_size", "grp_live", "free_blocks", "mapped_pages", "n_mig",
    "n_dropped", "n_erase", "clock",
)
# the fields among them that are one counter a drive ([D])
COUNTERS = ("erase_total", "erase_sq_total", "free_blocks", "mapped_pages",
            "n_mig", "n_dropped", "n_erase", "clock")
# SimState fields the fault hook reads or writes (a call with a fault
# policy only), and the policy's per-drive tensors with their dtypes
FAULT_FIELDS = ("retired_blocks", "spares_left", "grp_retired",
                "drive_status", "degraded_at", "n_erase_fail", "fault_draws",
                "n_app")
FAULT_POLICY = {"fault_rate": torch.float32, "fault_rate_worn": torch.float32,
                "endurance_limit": torch.int32, "fault_seed": torch.int64}
# SimState fields a demoting drain reads besides STATE_FIELDS: the groups'
# rates (the colder-neighbour walk's hit rates; every demoting detector)
# and the bloom pair (the bloom detector)
DEMOTE_FIELDS = ("grp_p", "bloom_active", "bloom_passive")
# the FDP detector's per-drive rates, which its demoting drain reads
FDP_POLICY = ("page_rate", "fdp_rate")
# the kernel's pointer struct (Ptrs in gc_one.cu), in order
ORDER = (STATE_FIELDS + ("gc_w", "g", "enable", "out") + FAULT_FIELDS
         + tuple(FAULT_POLICY) + DEMOTE_FIELDS + FDP_POLICY)


def check_state(state) -> None:
    """Raise unless ``state`` maps :data:`STATE_FIELDS` to the SimState
    fields' tensors with a leading drive axis (D >= 1), each in its dtype
    and shape, contiguous, on one device, with 1-64 groups and 1-1,024
    pages a block."""
    missing = [k for k in STATE_FIELDS if k not in state]
    if missing:
        raise ValueError(f"gc_one: state lacks {missing}")
    if state["slot_lba"].dim() != 3 or state["slot_lba"].shape[0] < 1:
        raise ValueError("gc_one: wants slot_lba [D, K, B], got "
                         f"{tuple(state['slot_lba'].shape)}")
    d, k, b = state["slot_lba"].shape
    n_groups = state["grp_size"].shape[-1]
    if not 1 <= n_groups <= MAX_GROUPS or not 1 <= b <= MAX_PAGES:
        raise ValueError(f"gc_one: {n_groups} groups and {b} pages a block; "
                         f"the kernel takes 1-{MAX_GROUPS} and 1-{MAX_PAGES}")
    i32 = torch.int32
    shapes = {
        "page_map": (i32, (d, state["page_map"].shape[-1])),
        "slot_lba": (i32, (d, k, b)), "valid": (torch.bool, (d, k, b)),
        "state": (torch.int8, (d, k)),
        **{f: (i32, (d, k)) for f in ("live", "fill", "stamp", "group_of",
                                       "erase_count", "trim_dead")},
        **{f: (i32, (d, n_groups)) for f in (
            "active_blk", "grp_phys", "grp_alloc", "grp_surplus", "grp_size",
            "grp_live")},
        "grp_active": (torch.bool, (d, n_groups)),
        **{f: (i32, (d,)) for f in COUNTERS},
    }
    _build.check_tensors("gc_one", **{
        name: (state[name], dtype, shape)
        for name, (dtype, shape) in shapes.items()})


def demotes(td_mode: str, drain: bool) -> bool:
    """Whether a call's drain demotes (FDP or bloom detector)."""
    return drain and td_mode != "static"


def check_call(state, gc_w, g, out, *, mode, td_mode, drain, enable=None,
               fault_policy=None, fdp_policy=None,
               erase_max_retries=0) -> None:
    """Raise unless the rest of a call fits the checked ``state``: gc_w
    [D, 4] float32 (α, β, γ, τ); g [D] int64 in mode "gc", None in the
    others; out [D, 3] int64; enable [D] bool, or None (every drive);
    drain a bool; on a call whose drain demotes, the state's ``grp_p``
    [D, G] float32 and, under the bloom detector, its ``bloom_active`` and
    ``bloom_passive`` [D, G, bits] bool; fdp_policy :data:`FDP_POLICY`'s
    ``page_rate`` [D, LBA] and ``fdp_rate`` [D, G] float32 on a demoting
    call under the FDP detector, None on every other; fault_policy None,
    or, on a call that drains, :data:`FAULT_POLICY`'s tensors [D] with the
    state's :data:`FAULT_FIELDS` (the hook acts on a drain's erase);
    contiguous, on the state's device; erase_max_retries 0-30."""
    if not 0 <= erase_max_retries <= 30:
        raise ValueError(f"gc_one: erase_max_retries={erase_max_retries}")
    if mode not in MODES:
        raise ValueError(f"gc_one: mode {mode!r} not in {MODES}")
    if td_mode not in TD_MODES:
        raise ValueError(f"gc_one: td_mode {td_mode!r} not in {TD_MODES}")
    if not isinstance(drain, bool):
        raise ValueError(f"gc_one: drain={drain!r}, not a bool")
    fdp = demotes(td_mode, drain) and td_mode == "fdp"
    if (fdp_policy is None) == fdp:
        raise ValueError("gc_one: the FDP rates go with a demoting drain "
                         "under the FDP detector, and with no other call")
    if fault_policy is not None and not drain:
        raise ValueError("gc_one: a fault policy on a call that only "
                         "decides (the hook acts on a drain's erase)")
    if (g is None) != (mode != "gc"):
        raise ValueError(f"gc_one: mode {mode!r} takes "
                         + ("g [D]" if mode == "gc" else "no g"))
    d = state["slot_lba"].shape[0]
    specs = {"page_map": (state["page_map"], torch.int32,
                          state["page_map"].shape),
             "gc_w": (gc_w, torch.float32, (d, 4)),
             "out": (out, torch.int64, (d, 3))}
    if g is not None:
        specs["g"] = (g, torch.int64, (d,))
    if enable is not None:
        specs["enable"] = (enable, torch.bool, (d,))
    if demotes(td_mode, drain):
        n_groups = state["grp_size"].shape[-1]
        fields = DEMOTE_FIELDS if td_mode == "bloom" else ("grp_p",)
        missing = [k for k in fields if k not in state]
        if missing:
            raise ValueError(f"gc_one: state lacks {missing}")
        specs["grp_p"] = (state["grp_p"], torch.float32, (d, n_groups))
        if td_mode == "bloom":
            bits = state["bloom_active"].shape[-1]
            for k in ("bloom_active", "bloom_passive"):
                specs[k] = (state[k], torch.bool, (d, n_groups, bits))
        else:
            specs["page_rate"] = (fdp_policy["page_rate"], torch.float32,
                                  state["page_map"].shape)
            specs["fdp_rate"] = (fdp_policy["fdp_rate"], torch.float32,
                                 (d, n_groups))
    if fault_policy is not None:
        missing = [k for k in FAULT_FIELDS if k not in state]
        if missing:
            raise ValueError(f"gc_one: state lacks {missing}")
        n_groups = state["grp_size"].shape[-1]
        for k in FAULT_FIELDS:
            dtype = torch.uint32 if k == "fault_draws" else torch.int32
            shape = (d, n_groups) if k == "grp_retired" else (d,)
            specs[k] = (state[k], dtype, shape)
        for k, dtype in FAULT_POLICY.items():
            specs[k] = (fault_policy[k], dtype, (d,))
    _build.check_tensors("gc_one", **specs)


def check_args(state, gc_w, g, out, enable=None, fault_policy=None,
               fdp_policy=None, *, mode, td_mode, drain, gc_reserve_blocks,
               erase_max_retries=0) -> None:
    """Raise unless the arguments are what the kernel takes
    (:func:`check_state`, :func:`check_call`; gc_reserve_blocks: any
    int)."""
    del gc_reserve_blocks
    check_state(state)
    check_call(state, gc_w, g, out, mode=mode, td_mode=td_mode, drain=drain,
               enable=enable, fault_policy=fault_policy,
               fdp_policy=fdp_policy, erase_max_retries=erase_max_retries)


# the last read-only state mapping launched on, and its packed pointers
_packed = (None, None)


def _state_pointers(state) -> list:
    """The data pointers of ``state``'s :data:`STATE_FIELDS`, checked. A
    read-only mapping (``types.MappingProxyType``, as
    ``SimState.drive_axis`` is: its fields are never rebound) holds the
    same tensors for its life, so it is checked and packed once."""
    global _packed
    if _packed[0] is state:
        return _packed[1]
    check_state(state)
    ptrs = [state[k].data_ptr() for k in STATE_FIELDS]
    if isinstance(state, types.MappingProxyType):
        _packed = (state, ptrs)
    return ptrs


def gc_one_cuda(state, gc_w, g, out, enable=None, fault_policy=None,
                fdp_policy=None, *, mode, td_mode, drain, gc_reserve_blocks,
                erase_max_retries=0) -> None:
    """Launch the kernel on the current stream: one GC per enabled drive,
    decided (and with ``drain`` drained, demoting under the FDP and bloom
    detectors, its erase through the fault hook when ``fault_policy`` is
    given) on the card, in place; writes (victim, g, do) into ``out``,
    (-1, -1, 0) for a drive that ``enable`` leaves out."""
    global launches, demote_launches
    state_ptrs = _state_pointers(state)
    check_call(state, gc_w, g, out, mode=mode, td_mode=td_mode, drain=drain,
               enable=enable, fault_policy=fault_policy,
               fdp_policy=fdp_policy, erase_max_retries=erase_max_retries)
    if not out.is_cuda:
        raise ValueError(f"gc_one_cuda: tensors on {out.device}")
    fn = _build.launcher("gc_one")
    if fault_policy is None:
        fault_ptrs = [None] * (len(FAULT_FIELDS) + len(FAULT_POLICY))
    else:
        fault_ptrs = [state[k].data_ptr() for k in FAULT_FIELDS] + [
            fault_policy[k].data_ptr() for k in FAULT_POLICY]
    demote = demotes(td_mode, drain)
    bloom = demote and td_mode == "bloom"
    demote_ptrs = [
        state["grp_p"].data_ptr() if demote else None,
        *(state[k].data_ptr() if bloom else None
          for k in ("bloom_active", "bloom_passive")),
        *(None if fdp_policy is None else fdp_policy[k].data_ptr()
          for k in FDP_POLICY)]
    ptrs = (ctypes.c_void_p * len(ORDER))(
        *state_ptrs, gc_w.data_ptr(), None if g is None else g.data_ptr(),
        None if enable is None else enable.data_ptr(), out.data_ptr(),
        *fault_ptrs, *demote_ptrs)
    n_drives, k, b = state["slot_lba"].shape
    dims = (ctypes.c_longlong * 7)(
        state["page_map"].shape[-1], k, b, state["grp_size"].shape[-1],
        gc_reserve_blocks, erase_max_retries,
        state["bloom_active"].shape[-1] if bloom else 0)
    # Drain in gc_one.cu: none, static, demote
    err = fn(ptrs, len(ORDER), dims, len(dims), n_drives, MODES.index(mode),
             2 if demote else int(drain),
             torch.cuda.current_stream(out.device).cuda_stream)
    _build.check_launch("gc_one", err)
    launches += 1
    demote_launches += demote
