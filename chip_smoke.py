"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py [--seed N] [--writes N] [--small-writes N] [--iters N]
                          [--profile-writes N]

Phases, one JSON line each; any failed check exits non-zero:

  env         the card (nvidia-smi name and power limit), torch and CUDA
              versions, and the wall time of building the kernels;
  kernels     each hand-written kernel against its plain PyTorch version on
              random valid inputs at the simulator's Table-2 widths, for one
              drive and for 64: outputs must be equal (integers, exact);
              times over CUDA events, with the bytes-over-HBM bound;
  equiv_small wolf/two_modal and single_group/uniform at Geometry(4, 32, 8)
              on the card and on the CPU: traces and state must agree;
  full_width  the paper's Table-2 drive (Geometry(8, 1024, 128), 1,048,576
              pages, LBA/PBA 0.70) under wolf on two_modal, through
              managers.simulate on the card with the kernels' launch counts
              set to 0 just before and read just after, then the same seed
              on the CPU: traces must agree and invariants hold;
  profile     a short Table-2 run under torch.profiler: device busy time
              against wall time (the idle share), kernels per write, and
              the kernels that take the most device time.

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
    from repro_torch.kernels.write_path.kernel import apply_write_cuda
    from repro_torch.kernels.write_path.ref import apply_write_flat

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
    n = args.small_writes
    for mcfg, phase in (
        (managers.wolf(), workloads.two_modal(geom.lba_pages, n)),
        (managers.single_group(), workloads.uniform(geom.lba_pages, n)),
    ):
        runs = {
            dev: managers.simulate(geom, mcfg, [phase], seed=args.seed,
                                   device=dev)
            for dev in ("cuda", "cpu")
        }
        bad = same_run(torch, runs["cuda"], runs["cpu"])
        check(not bad, f"equiv_small {mcfg.name}: cuda != cpu in {bad}")
        assert_invariants(runs["cuda"].state, f"equiv_small {mcfg.name}")
        emit({
            "phase": "equiv_small", "manager": mcfg.name,
            "geometry": [4, 32, 8], "writes": n, "identical": True,
            "wa_total": runs["cuda"].wa_total,
            "host_syncs": runs["cuda"].host_syncs,
        })


def phase_full_width(torch, args, card):
    from repro_torch.core import managers, simulator, workloads
    from repro_torch.core.ssd import Geometry, assert_invariants
    from repro_torch.kernels.gc_compact import kernel as gc_kernel
    from repro_torch.kernels.write_path import kernel as wp_kernel

    geom = Geometry(**TABLE2)
    phase = workloads.two_modal(geom.lba_pages, args.writes, p_hot=0.9,
                                frac_hot=0.5)
    wp_kernel.launches = 0
    gc_kernel.launches = 0
    simulator.host_syncs = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_run = managers.simulate(geom, managers.wolf(), [phase],
                                 seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {
        "apply_write": wp_kernel.launches,
        "compact_slots": gc_kernel.launches,
    }
    for name, n in launches.items():
        check(n > 0, f"full_width: the main path never launched {name}")
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


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def phase_profile(torch, args, card):
    """Where the card's time goes in the main path (Table-2 wolf run)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import managers, workloads
    from repro_torch.core.ssd import Geometry

    geom = Geometry(**TABLE2)
    phase = workloads.two_modal(geom.lba_pages, args.profile_writes,
                                p_hot=0.9, frac_hot=0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        managers.simulate(geom, managers.wolf(), [phase], seed=args.seed + 1,
                          device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda]
    busy_us = sum(_device_us(e) for e in kern)
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=_device_us, reverse=True)[:6]
    line = {
        "phase": "profile", "writes": args.profile_writes,
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6 if kern else "not measured",
        "device_idle_share": 1 - busy_us / 1e6 / wall if kern
        else "not measured",
        "kernels_per_write": launches / args.profile_writes,
        "top_kernels": [[e.key[:80], _device_us(e) / 1e3, e.count]
                        for e in top],
        "card": card,
    }
    emit(line)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--writes", type=int, default=100_000)
    ap.add_argument("--small-writes", type=int, default=6000)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--profile-writes", type=int, default=1000)
    args = ap.parse_args()

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
    kernels = phase_kernels(torch, args, card)
    phase_equiv_small(torch, args)
    full = phase_full_width(torch, args, card)
    phase_profile(torch, args, card)

    replaces = {
        "apply_write": "src/repro/kernels/write_path/kernel.py:66",
        "compact_slots": "src/repro/kernels/gc_compact/kernel.py:67",
    }
    summary = []
    for name in ("apply_write", "compact_slots"):
        k1 = kernels[(name, 1)]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": full["launches"][name],
            "max_abs_err": max(kernels[(name, d)]["max_abs_err"]
                               for d in (1, 64)),
            "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "library_ms": None,
        })
    emit({"kernels": summary})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
