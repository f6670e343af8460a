"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py [--seed N] [--writes N] [--churn-events N]
                          [--small-writes N] [--iters N] [--profile-writes N]

Phases, one JSON line each; any failed check exits non-zero:

  env         the card (nvidia-smi name and power limit), torch and CUDA
              versions, and the wall time of building the kernels;
  kernels     each hand-written kernel against its plain PyTorch version on
              random valid inputs at the simulator's Table-2 widths, for one
              drive and for 64: outputs must be equal (integers, exact);
              times over CUDA events, with the bytes-over-HBM bound;
  equiv_small six preset/workload pairs at Geometry(4, 32, 8) on the card
              and on the CPU (static wolf and single_group, fdp on the §6.2
              swap, wolf_dynamic on tpcc_like, and TRIM op streams):
              traces and state must agree;
  full_width  the paper's Table-2 drive (Geometry(8, 1024, 128), 1,048,576
              pages, LBA/PBA 0.70) under wolf on two_modal, through
              managers.simulate on the card with the kernels' launch counts
              set to 0 just before and read just after, then the same seed
              on the CPU: traces must agree and invariants hold;
  full_width_churn  the same drive under wolf_dynamic (bloom detector,
              §5.6 demotion, §5.2 groups) on the tpcc_churn op stream, card
              then CPU, counts set to 0 just before the card run: traces and
              integer state must agree, TRIMs must land and nothing drop,
              and every kernel must have been launched;
  profile     short Table-2 runs of both paths under torch.profiler: device
              busy time against wall time (the idle share), kernels per
              event, and the kernels that take the most device time.

Then the kernel summary line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TABLE2 = dict(n_luns=8, blocks_per_lun=1024, pages_per_block=128,
              lba_pba=0.70)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` warm calls (CUDA events)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- kernel inputs ----------------------------------------------------------

def write_inputs(torch, gen, d, lba_pages, k, b):
    """Random valid apply_write inputs for d drives: pools, and one row per
    drive whose old_pm is the page's mapping (-1 for about a quarter of the
    drives), whose new slot differs from it, and with ok = 0 for about an
    eighth."""
    dev = "cuda"
    slots = k * b
    page_map = torch.randint(-1, slots, (d, lba_pages), generator=gen,
                             device=dev, dtype=torch.int32)
    slot_lba = torch.randint(-1, lba_pages, (d, k, b), generator=gen,
                             device=dev, dtype=torch.int32)
    valid = torch.rand((d, k, b), generator=gen, device=dev) < 0.5
    lba = torch.randint(0, lba_pages, (d,), generator=gen, device=dev)
    drive = torch.arange(d, device=dev)
    unmapped = torch.rand(d, generator=gen, device=dev) < 0.25
    page_map[drive, lba] = torch.where(unmapped, -1, page_map[drive, lba])
    old = page_map[drive, lba].long()
    new = torch.randint(0, slots, (d,), generator=gen, device=dev)
    new = torch.where(new == old, (new + 1) % slots, new)
    ok = (torch.rand(d, generator=gen, device=dev) >= 0.125).long()
    rows = torch.stack([lba, old, new, ok], 1).to(torch.int32).contiguous()
    return rows, page_map, slot_lba, valid


def trim_inputs(torch, gen, d, lba_pages, k, b):
    """Random valid apply_trim inputs for d drives: pools, and one row per
    drive whose old_pm is the page's mapping (-1, a re-trim, for about a
    quarter of the drives), with ok = 0 for about an eighth."""
    dev = "cuda"
    page_map = torch.randint(-1, k * b, (d, lba_pages), generator=gen,
                             device=dev, dtype=torch.int32)
    valid = torch.rand((d, k, b), generator=gen, device=dev) < 0.5
    lba = torch.randint(0, lba_pages, (d,), generator=gen, device=dev)
    drive = torch.arange(d, device=dev)
    unmapped = torch.rand(d, generator=gen, device=dev) < 0.25
    page_map[drive, lba] = torch.where(unmapped, -1, page_map[drive, lba])
    old = page_map[drive, lba].long()
    ok = (torch.rand(d, generator=gen, device=dev) >= 0.125).long()
    rows = torch.stack([lba, old, ok], 1).to(torch.int32).contiguous()
    return rows, page_map, valid


def compact_inputs(torch, gen, d, k, b):
    """Random valid compact_slots inputs for d drives, M = B moves each:
    sources and destinations are distinct slots of two adjacent blocks, so
    the two sets interleave; about a fifth of the rows are no-ops."""
    dev = "cuda"
    slot_lba = torch.randint(-1, 1 << 20, (d, k, b), generator=gen,
                             device=dev, dtype=torch.int32)
    valid = torch.rand((d, k, b), generator=gen, device=dev) < 0.5
    base = torch.randint(0, k - 1, (d, 1), generator=gen, device=dev) * b
    src = base + torch.argsort(
        torch.rand((d, 2 * b), generator=gen, device=dev), dim=1)[:, :b]
    dst = base + torch.argsort(
        torch.rand((d, 2 * b), generator=gen, device=dev), dim=1)[:, :b]
    noop = torch.rand((d, b), generator=gen, device=dev) < 0.2
    moves = [
        torch.where(noop, -1, src // b), src % b, dst // b, dst % b,
    ]
    moves = [m.to(torch.int32).contiguous() for m in moves]
    return slot_lba, valid, moves


# -- phases -----------------------------------------------------------------

def phase_kernels(torch, args, card):
    from repro_torch.kernels.gc_compact.kernel import compact_slots_cuda
    from repro_torch.kernels.gc_compact.ref import compact_slots_flat
    from repro_torch.kernels.write_path.kernel import (
        apply_trim_cuda,
        apply_write_cuda,
    )
    from repro_torch.kernels.write_path.ref import (
        apply_trim_flat,
        apply_write_flat,
    )

    geom_k = TABLE2["n_luns"] * TABLE2["blocks_per_lun"]
    b = TABLE2["pages_per_block"]
    lba_pages = int(geom_k * b * TABLE2["lba_pba"])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = {}
    for d in (1, 64):
        rows, page_map, slot_lba, valid = write_inputs(
            torch, gen, d, lba_pages, geom_k, b)
        outs = []
        for fn in (apply_write_cuda, apply_write_flat):
            pools = (page_map.clone(), slot_lba.clone(), valid.clone())
            fn(rows, *pools)
            torch.cuda.synchronize()
            outs.append(pools)
        err = max(
            (x.long() - y.long()).abs().max().item()
            for x, y in zip(*outs)
        )
        check(err == 0, f"apply_write D={d}: kernel != plain (max {err})")
        ok = rows[:, 3] != 0
        n_clear = int((ok & (rows[:, 1] >= 0)).sum())
        # 16 B row per drive; per ok row 1 B valid + 4 B slot_lba + 4 B
        # page_map stored, and 1 B more where an old slot is cleared
        nbytes = 16 * d + 9 * int(ok.sum()) + n_clear
        pools = (page_map, slot_lba, valid)
        line = {
            "phase": "kernels", "name": "apply_write", "drives": d,
            "lba_pages": lba_pages, "slots": geom_k * b,
            "equal": True, "max_abs_err": err,
            "kernel_ms": time_ms(torch, lambda: apply_write_cuda(rows, *pools),
                                 args.iters),
            "plain_ms": time_ms(torch, lambda: apply_write_flat(rows, *pools),
                                args.iters),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "card": card,
        }
        emit(line)
        results[("apply_write", d)] = line

        rows, page_map, valid = trim_inputs(torch, gen, d, lba_pages,
                                            geom_k, b)
        outs = []
        for fn in (apply_trim_cuda, apply_trim_flat):
            pools = (page_map.clone(), valid.clone())
            fn(rows, *pools)
            torch.cuda.synchronize()
            outs.append(pools)
        err = max(
            (x.long() - y.long()).abs().max().item()
            for x, y in zip(*outs)
        )
        check(err == 0, f"apply_trim D={d}: kernel != plain (max {err})")
        ok = rows[:, 2] != 0
        n_clear = int((ok & (rows[:, 1] >= 0)).sum())
        # 12 B row per drive; per ok row 4 B page_map stored, and 1 B of
        # valid where an old slot is cleared
        nbytes = 12 * d + 4 * int(ok.sum()) + n_clear
        pools = (page_map, valid)
        line = {
            "phase": "kernels", "name": "apply_trim", "drives": d,
            "lba_pages": lba_pages, "slots": geom_k * b,
            "equal": True, "max_abs_err": err,
            "kernel_ms": time_ms(torch, lambda: apply_trim_cuda(rows, *pools),
                                 args.iters),
            "plain_ms": time_ms(torch, lambda: apply_trim_flat(rows, *pools),
                                args.iters),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "card": card,
        }
        emit(line)
        results[("apply_trim", d)] = line

        slot_lba, valid, moves = compact_inputs(torch, gen, d, geom_k, b)
        outs = []
        for fn in (compact_slots_cuda, compact_slots_flat):
            pools = (slot_lba.clone(), valid.clone())
            fn(*pools, *moves)
            torch.cuda.synchronize()
            outs.append(pools)
        err = max(
            (x.long() - y.long()).abs().max().item()
            for x, y in zip(*outs)
        )
        check(err == 0, f"compact_slots D={d}: kernel != plain (max {err})")
        n_ok = int((moves[0] >= 0).sum())
        # 16 B of move row per move; per live move 5 B gathered, 5 B stored
        nbytes = 16 * d * b + 10 * n_ok
        pools = (slot_lba, valid)
        line = {
            "phase": "kernels", "name": "compact_slots", "drives": d,
            "blocks": geom_k, "pages_per_block": b, "moves": b,
            "equal": True, "max_abs_err": err,
            "kernel_ms": time_ms(
                torch, lambda: compact_slots_cuda(*pools, *moves), args.iters),
            "plain_ms": time_ms(
                torch, lambda: compact_slots_flat(*pools, *moves), args.iters),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None, "card": card,
        }
        emit(line)
        results[("compact_slots", d)] = line
    return results


def same_run(torch, a, b) -> list:
    """Fields (and traces) where two RunResults differ: integers exact,
    grp_p within 1e-6 (float32 EWMA)."""
    bad = [n for n in ("app", "mig") if not np.array_equal(
        getattr(a, n), getattr(b, n))]
    for k, v in a.state.items():
        x, y = v.cpu(), b.state[k].cpu()
        if k == "grp_p":
            if (x - y).abs().max().item() > 1e-6:
                bad.append(k)
        elif not torch.equal(x, y):
            bad.append(k)
    return bad


def phase_equiv_small(torch, args):
    from repro_torch.core import managers, workloads
    from repro_torch.core.ssd import Geometry, assert_invariants

    geom = Geometry(4, 32, 8)
    n, lba = args.small_writes, geom.lba_pages
    runs = [
        ("wolf", "two_modal", [workloads.two_modal(lba, n)]),
        ("single_group", "uniform", [workloads.uniform(lba, n)]),
        ("fdp", "swap_phases", list(workloads.swap_phases(lba, n // 2))),
        ("wolf_dynamic", "tpcc_like", [workloads.tpcc_like(lba, n)]),
        ("wolf_trim_aware", "tpcc_churn", [workloads.tpcc_churn(lba, n)]),
        ("single_group", "trimmed(uniform, 0.5)",
         [workloads.trimmed(workloads.uniform(lba, n), 0.5)]),
    ]
    for preset, workload, phases in runs:
        mcfg = getattr(managers, preset)()
        t0 = time.perf_counter()
        res = {
            dev: managers.simulate(geom, mcfg, phases, seed=args.seed,
                                   device=dev)
            for dev in ("cuda", "cpu")
        }
        seconds = time.perf_counter() - t0
        label = f"equiv_small {preset}/{workload}"
        bad = same_run(torch, res["cuda"], res["cpu"])
        check(not bad, f"{label}: cuda != cpu in {bad}")
        assert_invariants(res["cuda"].state, label)
        st = res["cuda"].state
        check(int(st.n_dropped) == 0, f"{label}: dropped writes")
        emit({
            "phase": "equiv_small", "manager": mcfg.name,
            "workload": workload, "geometry": [4, 32, 8], "events": n,
            "identical": True, "wa_total": res["cuda"].wa_total,
            "trims": int(st.n_trim), "groups_active": int(st.grp_active.sum()),
            "host_syncs": res["cuda"].host_syncs,
            "seconds_card_and_cpu": seconds,
        })


def zero_counts() -> None:
    """Set every kernel's launch count and the host-sync count to 0."""
    from repro_torch.core import simulator
    from repro_torch.kernels.gc_compact import kernel as gc_kernel
    from repro_torch.kernels.write_path import kernel as wp_kernel

    wp_kernel.launches = wp_kernel.trim_launches = 0
    gc_kernel.launches = 0
    simulator.host_syncs = 0


def read_launches() -> dict:
    from repro_torch.kernels.gc_compact import kernel as gc_kernel
    from repro_torch.kernels.write_path import kernel as wp_kernel

    return {
        "apply_write": wp_kernel.launches,
        "apply_trim": wp_kernel.trim_launches,
        "compact_slots": gc_kernel.launches,
    }


def phase_full_width(torch, args, card):
    from repro_torch.core import managers, workloads
    from repro_torch.core.ssd import Geometry, assert_invariants

    geom = Geometry(**TABLE2)
    phase = workloads.two_modal(geom.lba_pages, args.writes, p_hot=0.9,
                                frac_hot=0.5)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_run = managers.simulate(geom, managers.wolf(), [phase],
                                 seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for name in ("apply_write", "compact_slots"):
        check(launches[name] > 0,
              f"full_width: the main path never launched {name}")
    assert_invariants(card_run.state, "full_width (cuda)")

    t0 = time.perf_counter()
    cpu_run = managers.simulate(geom, managers.wolf(), [phase],
                                seed=args.seed, device="cpu")
    cpu_seconds = time.perf_counter() - t0
    bad = same_run(torch, card_run, cpu_run)
    check(not bad, f"full_width: cuda != cpu in {bad}")
    check(np.isfinite(card_run.wa_total) and card_run.wa_total >= 1.0,
          f"full_width: WA {card_run.wa_total}")
    line = {
        "phase": "full_width", "manager": "wolf", "workload":
        "two_modal(p_hot=0.9, frac_hot=0.5)",
        "geometry": [TABLE2["n_luns"], TABLE2["blocks_per_lun"],
                     TABLE2["pages_per_block"]],
        "lba_pages": geom.lba_pages,
        "writes": args.writes, "intervals": int(card_run.state.interval),
        "identical_to_cpu": True, "invariants": True,
        "wa_total": card_run.wa_total,
        "seconds": seconds, "writes_per_s": args.writes / seconds,
        "cpu_seconds": cpu_seconds,
        "cpu_writes_per_s": args.writes / cpu_seconds,
        "host_syncs": card_run.host_syncs,
        "host_syncs_per_write": card_run.host_syncs / args.writes,
        "launches": launches, "card": card,
    }
    emit(line)
    return line


def phase_full_width_churn(torch, args, card):
    """wolf_dynamic on the tpcc_churn op stream at Table-2 size: the
    bloom detector, demoting drains, §5.2 groups and TRIMs."""
    from repro_torch.core import managers, simulator, workloads
    from repro_torch.core.ssd import Geometry, assert_invariants

    geom = Geometry(**TABLE2)
    n = args.churn_events
    phases = [workloads.tpcc_churn(geom.lba_pages, n)]
    mcfg = managers.wolf_dynamic()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_run = managers.simulate(geom, mcfg, phases, seed=args.seed,
                                 device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    syncs = simulator.host_syncs
    for name, count in launches.items():
        check(count > 0, f"full_width_churn: the path never launched {name}")
    st = card_run.state
    assert_invariants(st, "full_width_churn (cuda)")
    check(int(st.n_trim) > 0, "full_width_churn: no TRIM landed")
    check(int(st.n_dropped) == 0, "full_width_churn: dropped writes")

    t0 = time.perf_counter()
    cpu_run = managers.simulate(geom, mcfg, phases, seed=args.seed,
                                device="cpu")
    cpu_seconds = time.perf_counter() - t0
    bad = same_run(torch, card_run, cpu_run)
    check(not bad, f"full_width_churn: cuda != cpu in {bad}")
    check(np.isfinite(card_run.wa_total) and card_run.wa_total >= 1.0,
          f"full_width_churn: WA {card_run.wa_total}")
    writes = int(st.n_app)
    line = {
        "phase": "full_width_churn", "manager": mcfg.name,
        "workload": "tpcc_churn",
        "geometry": [TABLE2["n_luns"], TABLE2["blocks_per_lun"],
                     TABLE2["pages_per_block"]],
        "lba_pages": geom.lba_pages, "events": n, "writes": writes,
        "trims": int(st.n_trim), "migrations": int(st.n_mig),
        "erases": int(st.n_erase), "intervals": int(st.interval),
        "groups_active": int(st.grp_active.sum()),
        "groups_created": int((st.grp_created > 0).sum()),
        "identical_to_cpu": True, "invariants": True,
        "wa_total": card_run.wa_total,
        "seconds": seconds, "events_per_s": n / seconds,
        "cpu_seconds": cpu_seconds, "cpu_events_per_s": n / cpu_seconds,
        "host_syncs": syncs, "host_syncs_per_event": syncs / n,
        "host_syncs_per_write": syncs / writes,
        "launches": launches, "card": card,
    }
    emit(line)
    return line


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def phase_profile(torch, args, card):
    """Where the card's time goes on both paths (Table-2 wolf on two_modal,
    and wolf_dynamic on the tpcc_churn op stream)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import managers, workloads
    from repro_torch.core.ssd import Geometry

    geom = Geometry(**TABLE2)
    n = args.profile_writes
    paths = [
        ("full_width", managers.wolf(),
         workloads.two_modal(geom.lba_pages, n, p_hot=0.9, frac_hot=0.5)),
        ("full_width_churn", managers.wolf_dynamic(),
         workloads.tpcc_churn(geom.lba_pages, n)),
    ]
    for path, mcfg, phase in paths:
        torch.cuda.synchronize()
        # device activity only: the host-side op records are not read, and
        # collecting them costs minutes after the window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = managers.simulate(geom, mcfg, [phase], seed=args.seed + 1,
                                    device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        cuda = torch.autograd.DeviceType.CUDA
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == cuda]
        busy_us = sum(_device_us(e) for e in kern)
        launches = sum(e.count for e in kern)
        top = sorted(kern, key=_device_us, reverse=True)[:6]
        emit({
            "phase": "profile", "path": path, "manager": mcfg.name,
            "events": n, "wall_s": wall,
            "device_busy_s": busy_us / 1e6 if kern else "not measured",
            "device_idle_share": 1 - busy_us / 1e6 / wall if kern
            else "not measured",
            "kernels_per_event": launches / n,
            "host_syncs_per_event": res.host_syncs / n,
            "top_kernels": [[e.key[:80], _device_us(e) / 1e3, e.count]
                            for e in top],
            "card": card,
        })


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--writes", type=int, default=100_000)
    ap.add_argument("--churn-events", type=int, default=50_000)
    ap.add_argument("--small-writes", type=int, default=6000)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--profile-writes", type=int, default=1000)
    args = ap.parse_args()
    t_start = time.perf_counter()

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")

    card = nvidia_smi()
    build_s = _build.build_all()
    emit({
        "phase": "env", "nvidia_smi": card,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "kernel_build_s": build_s,
    })
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(torch, args, *a)
        seconds[name] = time.perf_counter() - t0
        return out

    kernels = timed("kernels", phase_kernels, card)
    timed("equiv_small", phase_equiv_small)
    paths = {
        "full_width": timed("full_width", phase_full_width, card),
        "full_width_churn": timed("full_width_churn", phase_full_width_churn,
                                  card),
    }
    timed("profile", phase_profile, card)

    replaces = {
        "apply_write": "src/repro/kernels/write_path/kernel.py:66",
        "apply_trim": "src/repro/kernels/write_path/kernel.py:117",
        "compact_slots": "src/repro/kernels/gc_compact/kernel.py:67",
    }
    summary = []
    for name in replaces:
        k1 = kernels[(name, 1)]
        by_path = {p: line["launches"][name] for p, line in paths.items()}
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(kernels[(name, d)]["max_abs_err"]
                               for d in (1, 64)),
            "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "library_ms": None,
        })
    emit({"kernels": summary, "phase_s": seconds,
          "script_s": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
