"""ctypes binding of the run kernel (``kernels/csrc/write_run.cu``), which
lands a run of the simulator's fast-path events (fast WRITEs and TRIMs)
on the device (with faults, a degraded drive's events as halted no-ops):
the redesign, for the simulator's paths, of the Pallas TPU kernels
``apply_write`` and ``apply_trim`` in
``repro/kernels/write_path/kernel.py``."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# write_run_cuda launches since the count was last set to 0 (one per call)
launches = 0

TD_MODES = ("static", "fdp", "bloom")
# why a run stopped, stop[d, 2] (StopWhy in write_run.cu): the segment ran
# out; a write that needs the heavy path; a write whose bloom insert would
# rotate the filter pair, and nothing else; an index the host never hands
# over (a page outside the drive, a mapped page in an unowned block)
STOP_WHY = ("end", "heavy", "rotation", "index")
MAX_GROUPS = 64  # the kernel's shared per-group arrays

# SimState fields the kernel reads or writes, each with a leading drive axis
STATE_FIELDS = (
    "page_map", "slot_lba", "valid", "fill", "live", "group_of",
    "active_blk", "trim_dead", "grp_size", "grp_live", "grp_writes",
    "grp_active", "grp_p", "grp_surplus", "free_blocks", "mapped_pages",
    "n_app", "n_trim", "n_mig", "bloom_active", "bloom_passive",
    "bloom_writes",
)
# the fields among them that are one counter a drive ([D])
COUNTERS = ("free_blocks", "mapped_pages", "n_app", "n_trim", "n_mig")
# the kernel's pointer struct (Ptrs in write_run.cu), in order
ORDER = (
    "lbas", "ops", "start", "stop", "page_map", "slot_lba", "valid", "fill",
    "live", "group_of", "active_blk", "trim_dead", "grp_size", "grp_live",
    "grp_writes", "grp_active", "grp_p", "grp_surplus", "free_blocks",
    "mapped_pages", "n_app", "n_trim", "n_mig", "bloom_active",
    "bloom_passive", "bloom_writes", "page_group0", "page_rate", "fdp_rate",
    "app", "mig", "drive_status", "n_halted",
)
# SimState fields the halt guard reads or writes (with_faults only)
HALT_FIELDS = ("drive_status", "n_halted")


def check_args(lbas, ops, start, stop, state, policy, app, mig, *, h,
               trace_every, td_mode, movement_ops,
               bloom_rotate_min_writes, with_faults=False) -> None:
    """Raise unless the arguments are what the kernel takes: events lbas
    [D, n] int64 and ops [D, n] uint8 (or None: every event a WRITE);
    start [D, 2] and stop [D, 3] int64; ``state`` a mapping of
    :data:`STATE_FIELDS` to the SimState fields' tensors with a leading
    drive axis; ``policy`` page_rate [D, LBA] float32, fdp_rate [D, G]
    float32 and, with ops, page_group0 [D, LBA] int64; trace buffers app
    and mig [D, n / trace_every] int32; with_faults, the state's
    drive_status and n_halted [D] int32 too. All contiguous, on one
    device."""
    del movement_ops, bloom_rotate_min_writes  # any bool, any int
    missing = [k for k in STATE_FIELDS if k not in state]
    if missing:
        raise ValueError(f"write_run: state lacks {missing}")
    if lbas.dim() != 2 or lbas.shape[0] < 1 or state["slot_lba"].dim() != 3:
        raise ValueError(
            "write_run: wants lbas [D, n] and slot_lba [D, K, B], got "
            f"{tuple(lbas.shape)} and {tuple(state['slot_lba'].shape)}")
    if td_mode not in TD_MODES:
        raise ValueError(f"write_run: td_mode {td_mode!r} not in {TD_MODES}")
    d, n = lbas.shape
    if trace_every < 1 or n % trace_every or h < 1:
        raise ValueError(f"write_run: trace_every={trace_every} must divide "
                         f"n={n}, and h={h} be positive")
    _, k, b = state["slot_lba"].shape
    lba_pages = state["page_map"].shape[-1]
    g = state["grp_size"].shape[-1]
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"write_run: {g} groups, the kernel takes 1-"
                         f"{MAX_GROUPS}")
    bits = state["bloom_active"].shape[-1]
    i32, f32 = torch.int32, torch.float32
    specs = {
        "lbas": (lbas, torch.int64, (d, n)),
        "start": (start, torch.int64, (d, 2)),
        "stop": (stop, torch.int64, (d, 3)),
        "app": (app, i32, (d, n // trace_every)),
        "mig": (mig, i32, (d, n // trace_every)),
        "page_rate": (policy["page_rate"], f32, (d, lba_pages)),
        "fdp_rate": (policy["fdp_rate"], f32, (d, g)),
    }
    if ops is not None:
        specs["ops"] = (ops, torch.uint8, (d, n))
        specs["page_group0"] = (policy["page_group0"], torch.int64,
                                (d, lba_pages))
    shapes = {
        "page_map": (i32, (d, lba_pages)), "slot_lba": (i32, (d, k, b)),
        "valid": (torch.bool, (d, k, b)),
        **{f: (i32, (d, k)) for f in ("fill", "live", "group_of",
                                       "trim_dead")},
        **{f: (i32, (d, g)) for f in ("active_blk", "grp_size", "grp_live",
                                       "grp_writes", "grp_surplus",
                                       "bloom_writes")},
        "grp_active": (torch.bool, (d, g)), "grp_p": (f32, (d, g)),
        **{f: (i32, (d,)) for f in COUNTERS},
        "bloom_active": (torch.bool, (d, g, bits)),
        "bloom_passive": (torch.bool, (d, g, bits)),
    }
    if with_faults:
        shapes.update({f: (i32, (d,)) for f in HALT_FIELDS})
    for name, (dtype, shape) in shapes.items():
        if name not in state:
            raise ValueError(f"write_run: state lacks {name}")
        specs[name] = (state[name], dtype, shape)
    _build.check_tensors("write_run", **specs)


def write_run_cuda(lbas, ops, start, stop, state, policy, app, mig, *, h,
                   trace_every, td_mode, movement_ops,
                   bloom_rotate_min_writes, with_faults=False) -> None:
    """Launch the kernel on the current stream; lands each drive's run in
    place (with_faults: a degraded drive's events as halted no-ops) and
    writes where and why it stopped into ``stop``."""
    global launches
    check_args(lbas, ops, start, stop, state, policy, app, mig, h=h,
               trace_every=trace_every, td_mode=td_mode,
               movement_ops=movement_ops,
               bloom_rotate_min_writes=bloom_rotate_min_writes,
               with_faults=with_faults)
    if not lbas.is_cuda:
        raise ValueError(f"write_run_cuda: tensors on {lbas.device}")
    fn = _build.launcher("write_run")
    tensors = {**state, **policy, "lbas": lbas, "ops": ops, "start": start,
               "stop": stop, "app": app, "mig": mig}
    if ops is None:
        tensors["page_group0"] = None
    if not with_faults:
        tensors.update(dict.fromkeys(HALT_FIELDS))
    ptrs = (ctypes.c_void_p * len(ORDER))(*[
        None if tensors[k] is None else tensors[k].data_ptr() for k in ORDER])
    n_drives, n = lbas.shape
    _, k, b = state["slot_lba"].shape
    dims = (ctypes.c_longlong * 9)(
        n, state["page_map"].shape[-1], k, b, state["grp_size"].shape[-1],
        state["bloom_active"].shape[-1], h, trace_every,
        bloom_rotate_min_writes,
    )
    err = fn(ptrs, len(ORDER), dims, len(dims), n_drives,
             TD_MODES.index(td_mode), int(ops is not None),
             int(bool(movement_ops)),
             torch.cuda.current_stream(lbas.device).cuda_stream)
    _build.check_launch("write_run", err)
    launches += 1
