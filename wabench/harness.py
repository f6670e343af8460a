"""One run of one cell: set-up, the measured window, the check, the line.

The window is a closed loop of experiments. An experiment is one
``repro_torch.core.fleet.simulate_fleet`` call over the cell's D
pre-conditioned drives for the traffic's E events a drive, with the
default device sampler, through to its traces on the host; every drive of
every experiment has its own seed, drawn from the run's seed, the
experiment and the drive. The window ends when the experiment in flight
at ``seconds`` completes, and its time is the whole of that. Each
experiment's result is dropped before the next starts, but for the
drives the check samples from it (one in each of ``check_drives`` equal
strata of the fleet).

Set-up is the import, the kernels' libraries (built on a checkout's first
run), and one warm experiment at the cell's D over one §5.1 interval, so
that every path has run once and the allocator holds its blocks.

With ``trace`` the window is the same and the first experiment runs under
``torch.profiler``; the per-layer metrics are read from it and from the
program's counters over the window.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time

import numpy as np
import torch

from wabench import cell as cells
from wabench import check as checks
from wabench import streams, trace

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM, NVIDIA's data sheet
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level names
WARM = 1 << 40  # the warm experiment's index in the drive seeds
STATE_FIELDS = (
    "page_map", "slot_lba", "valid", "live", "fill", "stamp", "state",
    "group_of", "erase_count", "trim_dead", "active_blk", "grp_size",
    "grp_phys", "grp_p", "grp_writes", "grp_alloc", "grp_active",
    "grp_created", "grp_surplus", "grp_live", "bloom_active",
    "bloom_passive", "bloom_writes", "free_blocks", "mapped_pages", "n_app",
    "n_mig", "n_erase", "n_dropped", "n_trim", "erase_total",
    "erase_sq_total", "clock", "interval", "cooldown")


def src_on_path() -> None:
    src = str(cells.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, the names compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Program:
    """The system under test: the port's fleet, its inputs made from the
    cell's files, and its counters."""

    def __init__(self, config: dict, traffic: dict, device):
        src_on_path()
        from repro_torch.core import fleet, simulator, workloads
        from repro_torch.core.ssd import Geometry, ManagerConfig
        from repro_torch.kernels.gc_compact import kernel as gc_compact
        from repro_torch.kernels.gc_one import kernel as gc_one
        from repro_torch.kernels.write_run import kernel as write_run

        self.fleet, self.simulator = fleet, simulator
        self.kernels = {"gc_one": gc_one, "compact_slots": gc_compact,
                        "write_run": write_run}
        g = config["geometry"]
        self.geom = Geometry(g["n_luns"], g["blocks_per_lun"],
                             g["pages_per_block"], g["lba_pba"])
        self.mcfg = ManagerConfig(**{k: v for k, v in
                                     config["manager"].items()
                                     if k != "preset"})
        lba = self.geom.lba_pages

        def phase(ph):
            sizes, probs, trims = streams.phase_groups(ph, lba)
            return workloads.Phase(
                tuple(sizes), tuple(probs), int(ph["events"]),
                tuple(trims) if any(t > 0 for t in trims) else ())

        self.phases = tuple(phase(ph) for ph in traffic["phases"])
        h = max(16, int(lba * self.mcfg.interval_frac))
        self.warm_phases = (phase(dict(traffic["phases"][0], events=h)),)
        self.device = device
        self.drives = int(traffic["drives"])

    def experiment(self, seed: int, index: int, phases=None):
        specs = [self.fleet.DriveSpec(
            self.mcfg, phases or self.phases,
            seed=streams.drive_seed(seed, index, d))
            for d in range(self.drives)]
        return self.fleet.simulate_fleet(self.geom, specs, return_lbas=True,
                                         trace_every=1, device=self.device)

    def counters(self) -> dict:
        sim = self.simulator
        return {
            "rounds": sim.rounds, "host_syncs": sim.host_syncs,
            "interval_batches": sim.interval_batches,
            "heavy_writes": sum(sim.run_stops.values()),
            **{f"{k}_launches": m.launches for k, m in self.kernels.items()},
        }


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _kept(res, d: int, seed: int) -> dict:
    """Drive d's answers as the program gave them, to be judged against
    the stream of ``seed``, the drive's own (not the program's word)."""
    st = res.state(d)
    return {
        "seed": seed, "lbas": res.lbas[d].copy(),
        "app": res.app[d].copy(), "mig": res.mig[d].copy(),
        "state": {k: getattr(st, k).cpu().numpy() for k in STATE_FIELDS},
    }


def _work(res) -> dict:
    """The experiment's work as the drives' own counters tell it."""
    out = {}
    for k in ("n_app", "n_trim", "n_mig", "n_erase"):
        out[k] = int(sum(int(st[k].sum()) for _, st in res.shards))
    return out


def strata(seed: int, index: int, drives: int, n: int) -> list[int]:
    """One drive drawn from the seed in each of n equal strata."""
    rng = np.random.default_rng([seed & (2**63 - 1), index])
    edges = np.linspace(0, drives, n + 1).round().astype(int)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges[:-1],
                                                        edges[1:])]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device,
             t_start: float, workers: int = 4) -> tuple[dict, dict]:
    """One run; returns (the result line, the figures for earlier
    lines)."""
    cuda = torch.device(device).type == "cuda"
    # the load comes from this one thread: no CPU thread pool beside it
    torch.set_num_threads(1)
    config, traffic = cell["config"], cell["traffic"]
    prog = Program(config, traffic, device)
    build_s = 0.0
    if cuda:
        from repro_torch.kernels import _build
        build_s = _build.build_all()
    warm = prog.experiment(seed, WARM, prog.warm_phases)
    del warm
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    n_check = int(traffic["check_drives"])
    events = sum(int(ph["events"]) for ph in traffic["phases"])
    kept, tracked = [], None
    c0 = prog.counters()
    t0 = time.perf_counter()
    n_exp, ends = 0, []
    while True:
        prof = None
        if traced and n_exp == 0:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA] if cuda else [])])
            prof.__enter__()
            ct, tt = prog.counters(), time.perf_counter()
        res = prog.experiment(seed, n_exp)
        if prof is not None:
            if cuda:
                torch.cuda.synchronize()
            tt = time.perf_counter() - tt
            prof.__exit__(None, None, None)
            tracked = {"prof": prof, "wall_s": tt, "work": _work(res),
                       "counts": _delta(prog.counters(), ct)}
        kept += [_kept(res, d, streams.drive_seed(seed, n_exp, d))
                 for d in strata(seed, n_exp, prog.drives, n_check)]
        del res
        n_exp += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    elapsed = time.perf_counter() - t0
    counts = _delta(prog.counters(), c0)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    t_check = time.perf_counter()
    if cuda:
        torch.cuda.empty_cache()
    verdict = checks.check(kept, config, traffic, device, workers)
    check_s = time.perf_counter() - t_check
    numbers = verdict["numbers"]
    correct = verdict["checked"] > 0 and all(
        numbers[k] <= lim for k, lim in checks.LIMITS.items())

    d_total = n_exp * prog.drives
    e2e = {
        "events_per_s": (d_total * events / elapsed, "events/s"),
        "peak_mb_per_drive": (peak / prog.drives / 1e6, "MB"),
        "setup_s": (setup_s, "s"),
    }
    metrics, breakdown = {}, None
    if traced:
        summ = trace.summarize(tracked["prof"]) if tracked else None
        rec = {
            "ksteps": n_exp * events / 1000.0, "counts": counts,
            "drives": prog.drives, "events": events,
            "pages_per_block": prog.geom.pages_per_block,
            "op_stream": checks.with_trim(traffic),
            "hbm_bytes_per_s": HBM_BYTES_PER_S,
            "traced": dict(tracked, summary=summ, prof=None),
        }
        for m in cell["per_layer"]:
            v = cells.reader(m["name"], cell["root"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summ is not None:
            breakdown = {"device_ops": summ["device_ops"],
                         "idle_gaps": summ["idle_gaps"]}
    else:
        for m in cell["end_to_end"]:
            v, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}

    line = {
        "correct": bool(correct), "attempted": d_total,
        "failed": verdict["failed"], "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell["chips"], "memory_peak_bytes": peak,
        },
    }
    if traced and tracked:
        line["device"]["busy_s"] = summ["busy_s"]
        line["device"]["window_s"] = tracked["wall_s"]
    if breakdown:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": numbers[k], "limit": checks.LIMITS[k]}
                      for k in checks.LIMITS}
    info = {
        "cell": cell["name"], "seed": seed, "experiments": n_exp,
        "drives": prog.drives, "events_per_drive": events,
        "window_s": elapsed, "experiment_s": list(np.diff([0.0] + ends)),
        "setup_s": setup_s, "build_s": build_s,
        "check_s": check_s, "checked_drives": verdict["checked"],
        "mismatched_fields": verdict["fields"],
        "wa_checked": verdict["wa"], "counts": counts,
        "card": power_limit() if cuda else "cpu",
        "e2e": {k: v for k, (v, _) in e2e.items()},
    }
    if tracked:
        info["traced"] = {"wall_s": tracked["wall_s"],
                          "work": tracked["work"],
                          "counts": tracked["counts"],
                          "busy_s": summ["busy_s"],
                          "device_ops": summ["n_device_ops"]}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded in the measuring process: {found}")
    return line, info
