"""Build the port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py [--seed N] [--writes N] [--churn-events N]
                          [--small-writes N] [--iters N] [--profile-writes N]
                          [--run-warm N] [--fleet-drives D,D,...]
                          [--fleet-window N] [--fleet-mix-events N]
                          [--reference-writes N]
                          [--reference-churn-events N]
                          [--reference-endurance-writes N]
                          [--phases P,P,...]

Phases, one JSON line each; any failed check exits non-zero:

  env         the card (nvidia-smi name and power limit), torch and CUDA
              versions, the wall time of building the kernels, and for the
              two attention kernels, write_run, gc_one and gc_compact
              ptxas's registers, spills and static shared memory and the
              tensor-core instructions (HMMA) in their SASS: the bf16 flash
              kernel must have some;
  kernels     each hand-written kernel against its plain PyTorch version on
              random valid inputs: the simulator's three at Table-2 widths,
              for one drive and for 64, equal (integers, exact); the serving
              path's three at internlm2-1.8b's full width in fp32 and bf16
              (and at olmoe-1b-7b's: paged_attention at G = 1 over 16 KV
              heads, gc_compact at 16 KV heads; flash_attention at
              mixtral-8x22b's G = 6 with its 4,096 window over 4,608
              positions, and at llava-next-34b's G = 7):
              gc_compact exactly, paged_attention and flash_attention within
              1e-5 (fp32) and 2e-2 (bf16); times over CUDA events, with the
              least time the card could take (bytes over HBM, or operations
              over the peak rate), and for flash_attention PyTorch's
              scaled_dot_product_attention on the same inputs as a yardstick;
              the two attention kernels and SDPA are also timed queued (see
              time_ms), and paged_attention with L2 cold, rotating over four
              pool pairs (200 MB in bf16, four times the L2); the run kernel
              write_run from Table-2 states reached on the card (the two
              paths' configurations after --run-warm events), one drive and
              64, each launch from a fresh copy of the state and timed
              alone: ms, events per launch, us per event, exact against
              write_run_ref; the GC kernel gc_one from full_width's state
              after --run-warm writes, one drive and 64, in each mode (the
              heavy write's own GC with its open block full and over budget,
              the emergency valve, a movement operation), each launch from a
              fresh copy of the state and timed alone, queued and unqueued,
              exact against gc_one_ref, and at D = 64 with every odd
              drive disabled (a fleet round's mask); gc_one with the
              fault hook (a decided GC whose erase may fail and retire the
              block) at D = 1 and 64 from the same state, gc_one deciding
              without draining under the static detector (the reference
              drain's call) at D = 1 and 64, and write_run
              with the halt guard at D = 64 with every third drive
              degraded, each exact against its plain version; gc_compact
              on move lists whose
              sources overlap the destinations (two launches) and on
              disjoint ones (one);
  equiv_small six preset/workload pairs at Geometry(4, 32, 8) on the card
              and on the CPU (static wolf and single_group, fdp on the §6.2
              swap, wolf_dynamic on tpcc_like, and TRIM op streams):
              traces and state must agree; then the reference engine
              (fast_path=False, gc_impl="reference") on a sixth of the
              events: wolf, fdp on the swap, wolf_trim_aware on
              tpcc_churn, and a fleet of four (static, fdp, bloom on
              tpcc_churn, an fdp drive failing half its erase attempts),
              card = CPU;
  full_width  the paper's Table-2 drive (Geometry(8, 1024, 128), 1,048,576
              pages, LBA/PBA 0.70) under wolf on two_modal, through
              managers.simulate on the card with the kernels' launch counts
              set to 0 just before and read just after, then the same seed
              on the CPU: traces and host syncs must agree and invariants
              hold; every fast write lands through write_run (runs,
              events per run and the writes that stopped a run, heavy or
              for a bloom rotation alone, reported), none through
              apply_write;
  full_width_churn  the same drive under wolf_dynamic (bloom detector,
              §5.6 demotion, §5.2 groups) on the tpcc_churn op stream, card
              then CPU, counts set to 0 just before the card run: traces and
              integer state must agree, TRIMs must land and nothing drop,
              write_run and gc_one must have been launched, every gc_one
              launch with the demoting drain and none through
              compact_slots, and at the default depth and seed the host
              syncs must be 3,250;
  full_width_endurance  the same drive under wolf_endurance with a 5%
              erase failure floor, no retry and 32 spares (ENDURANCE) on
              full_width's stream, card then CPU, counts set to 0 just
              before the card run: traces and state must agree, blocks
              retire (gc_one's fault hook) and the drive degrades within
              the run, its later writes halted (write_run's halt guard);
  fleet       D Table-2 drives in lock-step (wolf on two_modal, seeds
              0..D-1, numpy streams, --writes each) for each D of
              --fleet-drives through fleet.simulate_fleet, counts set to 0
              just before each: drives x writes/s, rounds (write_run
              launches), interval batches (must be writes // h), host syncs,
              launches, WA, and a profile window of --fleet-window more
              writes a drive on the final states (the idle share); D = 1
              must equal full_width's run, drives 0, 31 and 63 of D = 64
              their single-drive card runs; the device sampler at D = 64
              (every drive's invariants, mean WA within 2% of the numpy
              fleet's); a mixed fleet of 14 drives of every sub-batch kind
              (static, a two-phase drive, fdp, single_group, bloom with
              §5.2, TRIM op streams; the fdp and both bloom sub-batches of
              several drives, so their masked tails run; two faulty fdp
              drives and a faulty bloom drive, so the fault hook after the
              demoting drain runs in gc_one) at --fleet-mix-events on the
              card and the CPU (in a process of its own, beside the card's
              run), identical;
  fleet_endurance  64 drives of full_width_endurance's configuration, fault
              seed d and stream seed --seed + d, in lock-step, counts set
              to 0 just before: drive-writes/s, rounds, each drive's time
              to degrade and the survival fraction at four points; drive 0
              must equal full_width_endurance's run, drives 31 and 63
              their runs alone on the card;
  full_width_reference  the reference engine (every event stepped alone,
              each GC drained page by page) at Table-2 width against the
              split engine on the card over the same events, exact: (a)
              wolf on full_width's stream, its first --reference-writes
              writes; (b) wolf_dynamic on the churn stream, its first
              --reference-churn-events events, one apply_trim launch a
              TRIM; (c) full_width_endurance's configuration on (a)'s
              stream, its first --reference-endurance-writes writes,
              degrading at write 665 with 33 retired at the default seed
              and --writes; (d) (a) with write_run's runs and the
              reference drain. Each case in a process of its own, the four
              at once; counts set to 0 just before each; seconds,
              events/s, host syncs and launches a case (the oracle's
              cost, no claim; the examples phase's fleet_sweep runs in a
              process of its own beside it, waited for when it ends);
  serve_full_width  the Wolf-KV serving engine on internlm2-1.8b at its
              full published width in bf16 (random weights from --seed): 48
              requests of 256 prompt tokens and 256 new ones, policies
              cycling append / h2o:50 / window:32, 768 KV blocks of 16 slots,
              batch 32, counts set to 0 just before: decode tokens/s, step
              and prefill times, WA, launches, peak memory; the control plane
              (steps, appended, copied, every move list) must equal the same
              request set's at smoke width on the CPU, every block must be
              free at the end, and every logit finite;
  serve_moe   the same engine, request set and checks on olmoe-1b-7b
              (arXiv:2409.02060) at its full published width and depth in
              bf16 (16 layers, 64 experts, top-8: each prefill takes the
              MoE capacity path, one group of 256 tokens with 40 slots an
              expert, each decode step the exact dense path;
              paged_attention at G = 1 over 16 KV heads); the control
              plane is held to the same CPU smoke run as serve_full_width
              (made once a call: the manager never sees the model);
  dense_vs_paged  internlm2-1.8b at full width in fp32: two 512-token prompts
              through the dense prefill (the flash kernel) and the paged
              prefill, four decode steps on both, then scattered evictions,
              a compaction (the gc_compact kernel) and one more decode
              against the dense cache with the evicted positions masked:
              logits must agree within 2e-3 at every step;
  vlm_prefill llava-next-34b at full width in fp32, 8 of its 60 layers:
              two sequences of 512 stub patch embeddings and 1,536 text
              tokens (_seq_split of 2,048) prefilled with decode headroom
              (the flash kernel at G = 7), four decode steps, each step's
              logits within 2e-3 of the last-token logits of a prefill over
              the sequence extended to that token;
  xlstm_full_width, hymba_full_width, whisper_full_width  each family at
              full width: bf16 at full depth timed, fp32 decode against
              extended prefills, fp32 at a depth cut card = CPU, no kernel
              launched (see FAMILY_PHASES);
  train_full_width  the trainer on internlm2-1.8b at full width and depth
              in bf16 (random weights from --seed): TokenStream batches of
              8 x 512 in 2 microbatches, 10 steps of make_train_step, counts
              set to 0 just before: step ms, tokens/s, peak memory, loss and
              grad_norm at steps 1 and 10, 96 flash_attention launches a
              step (24 layers x 2 microbatches x forward and each block's
              recompute), every gradient finite and not all zero after step
              1; one more step profiled (the backward's attention
              recompute's share); one more step under utils.opcount on the
              card against launch.dryrun.run_cell's count of the same step
              on the meta device: flops equal, the flash kernel's cost
              records equal its 96 launches, bytes within 1% (the ops that
              differ listed), the meta peak within 10% of
              max_memory_allocated over the step;
  train_card_vs_cpu  internlm2-1.8b at full width in fp32, 2 of 24 layers,
              2 x 256 tokens: one step (AdamW at lr 1e-3, no warmup, so
              each element with a gradient moves by about 1e-3) on the card
              and on the CPU from the same weights: loss within 1e-5
              relative, every gradient within 1e-4 of its leaf's largest
              value, params after the card's AdamW within 1e-5 of the
              CPU's AdamW applied to the card's gradients; the card's fp32
              gradients (all but the embedding tables) through
              sharding.gradient's int8 codec with the CPU's noise:
              payloads, scales, error-feedback gradients and residuals, and
              compressed_all_reduce_mean as one participant, bit-equal to
              the CPU's;
  train_families  the other nine archs at smoke_config in fp32, the same
              step and bounds, every gradient finite; flash launches 2 a
              layer on the transformer families, 0 on xLSTM, Hymba and
              Whisper (the JAX package routes none there);
  train_runner  the smoke internlm2 through TrainRunner on the card: 12
              steps, a checkpoint every 4, a failure injected at step 6:
              one retry, a recovery, the last checkpoint at 12, the
              restored state on the card;
  examples    the five examples (repro_torch.examples) on the card at
              small arguments, each returning 0: fleet_sweep at 12,000
              writes a drive (its wear claim needs them) in a process of
              its own beside full_width_reference, the others one after
              another;
  moe_layer   one MoE layer at olmoe-1b-7b's full width (d 2048, f 1024, 64
              experts, top-8) in fp32 and bf16, and at mixtral-8x22b's
              (d 6144, f 16384, 8 experts, top-2) in fp32, weights made on
              the card: routed once on the CPU, that routing through the
              capacity path (T = 256, and T = 600 with 168 pad rows) or the
              dense path (T = 32) on the card and on the CPU, which must
              keep the same (token, choice) pairs and agree within 1e-5
              (fp32) or 2e-2 (bf16); how many tokens' top-k sets the card's
              own routing changes is reported, not checked;
  allocation  optimal_allocation and hillclimb_allocation for
              full_width's drive (two halves of the logical pages, updated
              0.9 / 0.1, over its OP) on the card and on the CPU: card =
              CPU, the optimum no worse than the closed form, the hill
              climber within 0.5% of it;
  dryrun      python -m repro_torch.launch.dryrun --all over the card,
              single and multi meshes, started before the kernels build in
              a niced process group of its own (it needs no card) and
              joined here: one line a cell (flops, bytes, peak GB, fits in
              80 GB, dominant term, roofline_fraction, trace_s), every cell
              without error, xlstm-125m's train_4k and prefill_32k counted
              on the card through the recurrences' trip-count rule;
  profile     short runs of the simulator's two Table-2 paths (a fresh
              drive's first events, and a window after --run-warm events)
              and of the serving engine under torch.profiler: device busy
              time against wall time (the idle share), kernels per event,
              the kernels that take the most device time, and in the decode
              windows (serve_full_width's and serve_moe's engines)
              paged_attention's device time and share of busy time.

Then the kernel summary line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
before printing any result. With --phases it runs only the phases named
and ends with ``{"partial": [...]}`` instead: no kernel summary and no ok
line, since a partial run holds no kernel against its plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import multiprocessing
import os
import pathlib
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
# the H100 SXM data sheet's rates: HBM bytes/s, and the dense peak of each
# operation type
from repro_torch.utils.roofline import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS,
    model_flops,
)

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


def time_ms(torch, fn, iters: int, queued: bool = False,
            sleep_cycles: int = 200_000) -> float:
    """Mean ms per call of ``fn`` over ``iters`` warm calls (CUDA events).
    Unqueued, a call that is shorter on the card than its host cost
    (argument checks, the ctypes call) reads as that cost. ``queued``: the
    card first sleeps ``sleep_cycles`` a call (200,000: ~0.1 ms at ~2 GHz)
    while the host enqueues every call, so the calls run back to back and
    the host's cost drops out: device time, as long as the sleep outlasts
    the host's cost."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(iters * sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_both(torch, key: str, fn, iters: int,
              sleep_cycles: int = 200_000) -> dict:
    """``time_ms`` both ways: {key: unqueued, key + "_queued": queued}."""
    return {key: time_ms(torch, fn, iters),
            key + "_queued": time_ms(torch, fn, iters, queued=True,
                                     sleep_cycles=sleep_cycles)}


def device_ms(torch, fn, iters: int, names: dict) -> dict:
    """ms per call of ``fn`` on the card by torch.profiler, over ``iters``
    warm calls: {label: the self device time of the kernels and copies
    whose name holds names[label]}, "not measured" where the trace has
    none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda]
    out = {}
    for label, name in names.items():
        us = sum(_device_us(e) for e in events if name in e.key)
        out[label] = us / 1e3 / iters if us else "not measured"
    return out


NAMED_KERNELS = ("flash_bf16_kernel", "flash_fp32_kernel",
                 "paged_attention_kernel", "write_run_kernel", "gc_one_kernel",
                 "gc_compact_kernel")


def short_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name, as in
    flash_bf16_kernel<128>, paged_attention_kernel<bf16, 2> or
    write_run_kernel<2, 1, 1>."""
    m = re.search(rf"({'|'.join(NAMED_KERNELS)})I(.*?)EE", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E|(13__nv_bfloat16)|(f)(?=L|$)",
                      m.group(2) + "E")
    words = [n or ("bf16" if bf else "fp32") for n, bf, _ in args]
    return f"{m.group(1)}<{', '.join(words)}>"


def parse_ptxas(log: str) -> dict:
    """{kernel function (mangled): {"registers", "spill_stores",
    "spill_loads", "stack", "static_smem"}} from ``ptxas -v`` output."""
    report, fn = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            fn = report.setdefault(m.group(1), {})
        elif fn is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            fn.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                      spill_loads=int(m.group(3)))
        elif m := re.search(r"Used (\d+) registers", line):
            fn["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            fn["static_smem"] = int(s.group(1)) if s else 0
    return report


def count_opcode(sass: str, opcode: str) -> dict:
    """{kernel function (mangled): instructions with ``opcode``} in the
    text of ``cuobjdump -sass``."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if m := re.match(r"\s*Function : (\w+)", line):
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    return counts


def build_report(build) -> dict:
    """ptxas's figures (from the build's nvcc log) and the SASS's HMMA
    count for the two attention kernels, the run kernel, the GC kernel and
    the KV compaction, by kernel instantiation; fails unless every bf16
    flash instantiation runs on the tensor cores."""
    cuobjdump = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    report = {}
    for src in ("flash_attention", "paged_attention", "write_run", "gc_one",
                "gc_compact"):
        lib = build.library(src)
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        hmma = count_opcode(sass, "HMMA")
        for fn, info in parse_ptxas(
                lib.with_suffix(".log").read_text()).items():
            report[short_name(fn)] = {**info, "hmma": hmma.get(fn)}
    bf16 = [n for n in report if "flash_bf16_kernel" in n]
    check(bf16 and all(report[n]["hmma"] for n in bf16),
          f"flash_attention: bf16 kernels without HMMA: "
          f"{ {n: report[n]['hmma'] for n in bf16} }")
    return report


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


# the serving path: internlm2-1.8b at full width behind this engine
SERVE_ARCH = "internlm2-1.8b"
SERVE = dict(n_blocks=768, page=16, max_pages_per_seq=64, max_batch=32)
SERVE_POLICIES = ("append", "h2o:50", "window:32")  # launch/serve.py's cycle
SERVE_PROMPT = 256
# 48 requests of 256 new tokens: shorter sets never fill the pool enough
# for the h2o churn to compact (checked on the CPU at smoke width)
SERVE_REQUESTS, SERVE_NEW = 48, 256
# the MoE serving path (serve_moe: olmoe-1b-7b at full width and depth in
# bf16, behind the same engine and request set) and the VLM prefill
# (vlm_prefill: llava-next-34b at full width in fp32, 8 of its 60 layers,
# ~22 GB of weights, two sequences of 2,048 positions)
MOE_ARCH = "olmoe-1b-7b"
VLM_ARCH, VLM_LAYERS, VLM_SEQ = "llava-next-34b", 8, 2048


def serve_kv(cfg) -> dict:
    """The KV pool's shape on the serving path."""
    return dict(layers=cfg.n_layers, blocks=SERVE["n_blocks"],
                page=SERVE["page"], kv_heads=cfg.n_kv_heads,
                d_head=cfg.d_head)


def gc_inputs(torch, rng, dtype, kv, disjoint, moves=512):
    """K and V pools [L, N, P, Hkv, D] and a host move list [M, 4] of
    distinct destinations whose sources are drawn among all slots (so
    some are other rows' destinations: hazard rows) or, ``disjoint``,
    among the slots no row lands on; a tenth of the rows are no-ops."""
    shape = (kv["layers"], kv["blocks"], kv["page"], kv["kv_heads"],
             kv["d_head"])
    pools = [torch.randn(shape, device="cuda").to(dtype) for _ in range(2)]
    slots = rng.permutation(kv["blocks"] * kv["page"])
    dst = slots[:moves]
    src = rng.choice(slots[moves:] if disjoint else slots, moves,
                     replace=False)
    mv = np.stack([src // kv["page"], src % kv["page"], dst // kv["page"],
                   dst % kv["page"]], 1).astype(np.int32)
    mv[rng.random(moves) < 0.1, 0] = -1
    return pools, torch.from_numpy(mv)


def paged_inputs(torch, rng, dtype, kv, b, hq, m):
    """One decode token per sequence over the pool, laid out as the block
    manager lays it out: every page its own block (one permutation of the
    pool dealt out across the batch). Lengths 256-384, so that the batch's
    pages (at most 24 a sequence) fit the 768 blocks; about a fifth of the
    slots holes (the newest token always valid)."""
    n, p, hkv, d = kv["blocks"], kv["page"], kv["kv_heads"], kv["d_head"]
    lengths = rng.integers(256, 385, b).astype(np.int32)
    pages = -(-lengths // p)
    check(pages.sum() <= n, f"paged inputs: {pages.sum()} pages > {n}")
    blocks = np.split(rng.permutation(n)[:pages.sum()], np.cumsum(pages)[:-1])
    tables = np.full((b, m), -1, np.int32)
    valid = (rng.random((b, m, p)) < 0.8).astype(np.int8)
    for i in range(b):
        tables[i, :pages[i]] = blocks[i]
        t = int(lengths[i]) - 1
        valid[i, t // p, t % p] = 1
    q = torch.randn((b, hq, d), device="cuda").to(dtype)
    pools = [torch.randn((n, p, hkv, d), device="cuda").to(dtype)
             for _ in range(2)]
    rest = [torch.from_numpy(x).cuda() for x in (tables, lengths, valid)]
    return q, pools, rest


def flash_inputs(torch, dtype, hq, hkv, d, b=1, s=2048):
    return [(torch.randn(shape, device="cuda") * 0.5).to(dtype)
            for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))]


def row_rel_err(got, want) -> float:
    """The largest error of a row of the head dimension over that row's
    largest |plain| value: bf16 attention outputs can lie far below the
    absolute bound, so this holds every row at its own scale."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    return (err / want.abs().amax(-1).clamp_min(1e-30)).max().item()


ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ROW_TOL = 2e-2  # bf16: each row within 2% of its own largest value


def gc_case(torch, rng, dtype, kv, case, iters, card):
    """gc_compact_cuda against gc_compact_ref on one move list over the
    pools ``kv`` (the hazard rows staged where sources overlap)."""
    from repro_torch.kernels.gc_compact import kernel as gc_kernel
    from repro_torch.kernels.gc_compact.kernel import gc_compact_cuda
    from repro_torch.kernels.gc_compact.ref import gc_compact_ref

    tname = str(dtype).split(".")[1]
    esize = torch.finfo(dtype).bits // 8
    pools, moves = gc_inputs(torch, rng, dtype, kv,
                             disjoint=case == "disjoint")
    outs = []
    for fn in (gc_compact_cuda, gc_compact_ref):
        got = [t.clone() for t in pools]
        n0 = gc_kernel.kv_device_launches
        fn(*got, moves)
        torch.cuda.synchronize()
        outs.append(got)
        if fn is gc_compact_cuda:
            device_launches = gc_kernel.kv_device_launches - n0
    err = max((x.float() - y.float()).abs().max().item()
              for x, y in zip(*outs))
    check(err == 0, f"gc_compact {tname} {case} Hkv {kv['kv_heads']}: "
          f"kernel != plain (max {err})")
    del outs
    _, n_hazard = gc_kernel.plan_moves(moves, kv["blocks"], kv["page"])
    check(device_launches == 1 + (n_hazard > 0)
          and (n_hazard == 0) == (case == "disjoint"),
          f"gc_compact {tname} {case}: {device_launches} launches "
          f"for {n_hazard} hazard rows")
    live = int((moves[:, 0] >= 0).sum())
    row = kv["kv_heads"] * kv["d_head"] * esize
    # each live move reads and writes one slot of K and V per layer; the
    # move list is read once
    nbytes = 2 * 2 * kv["layers"] * live * row + 16 * len(moves)
    line = {
        "phase": "kernels", "name": "gc_compact", "dtype": tname,
        "case": case, **kv, "moves": len(moves), "live_moves": live,
        "hazard_rows": n_hazard, "device_launches": device_launches,
        "equal": True, "max_abs_err": err,
        # the host plans and uploads the list: ~0.5 ms of sleep a call
        # keeps the card queued behind it
        **time_both(torch, "kernel_ms", lambda: gc_compact_cuda(
            *pools, moves), iters, sleep_cycles=1_000_000),
        # the copy kernels alone, and the list's upload, on the card's own
        # clock
        **device_ms(torch, lambda: gc_compact_cuda(*pools, moves), iters,
                    {"device_ms": "gc_compact_kernel",
                     "upload_device_ms": "Memcpy HtoD"}),
        "plain_ms": time_ms(
            torch, lambda: gc_compact_ref(*pools, moves), iters),
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None, "card": card,
    }
    # the rate of the card's own time (queued)
    line["gb_per_s"] = nbytes / line["kernel_ms_queued"] / 1e6
    emit(line)
    return line


def paged_case(torch, rng, dtype, kv, hq, iters, card, cold: bool):
    """paged_attention_cuda against paged_attention_ref at the serving
    path's batch and table width over the pool ``kv``, with holes; with
    ``cold`` also timed with L2 cold, rotating over four pool pairs."""
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_cuda,
    )
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    tname = str(dtype).split(".")[1]
    esize = torch.finfo(dtype).bits // 8
    q, (kp, vp), rest = paged_inputs(torch, rng, dtype, kv,
                                     SERVE["max_batch"], hq,
                                     SERVE["max_pages_per_seq"])
    got = paged_attention_cuda(q, kp, vp, *rest)
    want = paged_attention_ref(q, kp, vp, *rest)
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    check(err <= ATTN_TOL[tname] and (tname == "float32" or rel <= ROW_TOL),
          f"paged_attention {tname} Hq {hq} / Hkv {kv['kv_heads']}: kernel "
          f"vs plain {err} (abs), {rel} (row-relative)")
    tables, lengths = rest[0].cpu(), rest[1].cpu()
    starts = torch.arange(tables.shape[1])[None] * kv["page"]
    pages = int(((tables >= 0) & (starts < lengths[:, None])).sum())
    page_bytes = kv["page"] * kv["kv_heads"] * kv["d_head"] * esize
    # K and V of every page read (each its own block), q in and out,
    # tables, lengths, holes
    nbytes = (2 * pages * page_bytes + 2 * q.numel() * esize
              + 4 * tables.numel() + 4 * len(lengths) + rest[2].numel())
    line = {
        "phase": "kernels", "name": "paged_attention", "dtype": tname,
        "batch": q.shape[0], "q_heads": hq, "group": hq // kv["kv_heads"],
        **kv, "max_pages": tables.shape[1], "pages_read": pages,
        "max_abs_err": err, "max_row_rel_err": rel,
        **time_both(torch, "kernel_ms", lambda: paged_attention_cuda(
            q, kp, vp, *rest), iters),
    }
    if cold:
        # three more pool pairs: four pairs are four times the L2 in bf16,
        # as the serving path's 24 layers are
        pools = [(kp, vp)] + [tuple(
            torch.randn_like(kp) for _ in range(2)) for _ in range(3)]
        pairs = itertools.cycle(pools)
        line.update(time_both(
            torch, "kernel_ms_cold",
            lambda: paged_attention_cuda(q, *next(pairs), *rest), iters))
        line["cold_pool_gb"] = sum(t.numel() * t.element_size()
                                   for pair in pools for t in pair) / 1e9
        del pools, pairs
    line.update({
        "plain_ms": time_ms(
            torch, lambda: paged_attention_ref(q, kp, vp, *rest), iters),
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None, "card": card,
    })
    # the rates of the card's own time (queued)
    line["gb_per_s"] = nbytes / line["kernel_ms_queued"] / 1e6
    if cold:
        line["gb_per_s_cold"] = nbytes / line["kernel_ms_cold_queued"] / 1e6
    emit(line)
    return line


def flash_case(torch, dtype, hq, hkv, d, s, window, iters, card, arch,
               b=1):
    """flash_attention_cuda against flash_attention_ref, causal, at ``b``
    sequences of s positions, beside PyTorch's
    scaled_dot_product_attention (with the window as a mask where there is
    one)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        cost,
        flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    tname = str(dtype).split(".")[1]
    q, k, v = flash_inputs(torch, dtype, hq, hkv, d, b=b, s=s)
    got = flash_attention_cuda(q, k, v, causal=True, window=window)
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    check(err <= ATTN_TOL[tname] and (tname == "float32" or rel <= ROW_TOL),
          f"flash_attention {tname} G {hq // hkv} window {window}: kernel vs "
          f"plain {err} (abs), {rel} (row-relative)")
    del got, want
    b = q.shape[0]
    # the kernel's own cost formula: the scored pairs' two products, q, k
    # and v read once, the output written once
    flops, nbytes = cost(q, k, causal=True, window=window)
    bounds = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
              "operations": flops / PEAK_FLOPS[tname] * 1e3}
    bound_by = max(bounds, key=bounds.get)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window:
        pos = torch.arange(s, device="cuda")
        mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - window)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
    line = {
        "phase": "kernels", "name": "flash_attention", "dtype": tname,
        "arch": arch, "batch": b, "seq": s, "q_heads": hq, "kv_heads": hkv,
        "group": hq // hkv, "d_head": d, "causal": True, "window": window,
        "max_abs_err": err, "max_row_rel_err": rel,
        **time_both(torch, "kernel_ms", lambda: flash_attention_cuda(
            q, k, v, causal=True, window=window), iters),
        "plain_ms": time_ms(
            torch, lambda: flash_attention_ref(q, k, v, causal=True,
                                               window=window), iters),
        "bytes": nbytes, "flops": flops, "bound_ms": bounds[bound_by],
        "bound_by": bound_by,
        **time_both(torch, "library_ms", library, iters),
        "card": card,
    }
    # the rate of the card's own time (queued)
    line["tflops"] = flops / line["kernel_ms_queued"] / 1e9
    emit(line)
    return line


def serving_kernels(torch, args, card):
    """The serving paths' three kernels at full width, fp32 and bf16:
    internlm2-1.8b's shapes (the summary's timed cases), olmoe-1b-7b's
    (paged_attention at G = 1 over 16 KV heads, gc_compact at 16 KV heads)
    and the flash kernel at mixtral-8x22b's G = 6 with its 4,096 window
    over 4,608 positions and llava-next-34b's G = 7."""
    from repro_torch.models.registry import get_config

    cfg, moe_cfg = get_config(SERVE_ARCH), get_config(MOE_ARCH)
    kv, moe_kv = serve_kv(cfg), serve_kv(moe_cfg)
    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    iters = max(10, args.iters // 20)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[1]
        for case in ("overlapping", "disjoint"):
            results[("gc_compact", tname, case)] = gc_case(
                torch, rng, dtype, kv, case, iters, card)
        results[("gc_compact", tname, MOE_ARCH)] = gc_case(
            torch, rng, dtype, moe_kv, "overlapping", iters, card)
        results[("paged_attention", tname)] = paged_case(
            torch, rng, dtype, kv, cfg.n_heads, iters, card, cold=True)
        results[("paged_attention", tname, MOE_ARCH)] = paged_case(
            torch, rng, dtype, moe_kv, moe_cfg.n_heads, iters, card,
            cold=False)
        results[("flash_attention", tname)] = flash_case(
            torch, dtype, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, 2048, 0,
            iters, card, SERVE_ARCH)
        # train_full_width's shape: a microbatch of 4 x 512
        results[("flash_attention", tname, "train")] = flash_case(
            torch, dtype, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            TRAIN_SEQ, 0, iters, card, SERVE_ARCH,
            b=TRAIN_BATCH // TRAIN_MICRO)
        for arch, s in (("mixtral-8x22b", 4608), (VLM_ARCH, 2048)):
            c = get_config(arch)
            results[("flash_attention", tname, arch)] = flash_case(
                torch, dtype, c.n_heads, c.n_kv_heads, c.d_head, s,
                c.sliding_window, max(5, iters // 5), card, arch)
        torch.cuda.empty_cache()
    return results


# the run kernel's cases: each path's configuration, in the state a run of
# --run-warm of its events leaves on the card
RUN_CASES = {
    "full_width": ("wolf", "two_modal", False),
    "full_width_churn": ("wolf_dynamic", "tpcc_churn", True),
}
RUN_EVENTS = 2048  # each drive's segment: longer than any run


def run_phase(workloads, lba_pages, workload, n):
    if workload == "two_modal":
        return workloads.two_modal(lba_pages, n, p_hot=0.9, frac_hot=0.5)
    return workloads.tpcc_churn(lba_pages, n)


_WARM = {}  # case -> its warmed drive, made once


def warm_drive(args, case):
    """A Table-2 drive in ``case``'s configuration after --run-warm of its
    events on the card: (ctx, state, run_kw, events), where run_kw is what
    simulator.run takes beside the events and events(n, seed) draws n
    more of them (ops, lbas) from the seed. Each case is warmed once; each
    call returns its own copy of the state."""
    if case not in _WARM:
        _WARM[case] = _warm(args, case)
    ctx, st, run_kw, events = _WARM[case]
    copy = dataclasses.replace(st, **{k: v.clone() for k, v in st.items()})
    return ctx, copy, run_kw, events


def _warm(args, case):
    from repro_torch.core import managers, simulator, workloads
    from repro_torch.core.ssd import Geometry

    preset, workload, trim = RUN_CASES[case]
    geom = Geometry(**TABLE2)
    mcfg = getattr(managers, preset)()

    def events(n, seed):
        return run_phase(workloads, geom.lba_pages, workload, n).sample_ops(
            np.random.default_rng(seed))

    st, n_groups, assumed_p, fdp_rate, rates, pg0 = managers.build_drive(
        geom, mcfg, [run_phase(workloads, geom.lba_pages, workload, 1)],
        device="cuda")
    ctx = simulator.SimContext(geom, mcfg, n_groups, with_trim=trim)
    run_kw = dict(page_rate=rates[0], assumed_p=assumed_p, fdp_rate=fdp_rate,
                  page_group0=pg0 if trim else None)
    if args.run_warm:
        ops, lbas = events(args.run_warm, args.seed)
        st, _ = simulator.run(ctx, st, lbas, ops=ops if trim else None,
                              device="cuda", **run_kw)
    return ctx, st, run_kw, events


def run_inputs(torch, args, case, d):
    """write_run's arguments for d drives, each in the state --run-warm
    events of ``case`` leave on the card, each with its own next
    RUN_EVENTS events; and the run's mode."""
    from repro_torch.core import simulator
    from repro_torch.kernels.write_run.kernel import COUNTERS, STATE_FIELDS

    ctx, st, run_kw, events = warm_drive(args, case)
    mcfg, trim = ctx.mcfg, ctx.with_trim
    policy = simulator.policy_from_config(ctx, "cuda", **run_kw)
    rows = [events(RUN_EVENTS, [args.seed, i]) for i in range(d)]

    def drives(t):
        return t.repeat(d, *[1] * (t.dim() - 1)).contiguous()

    inputs = dict(
        lbas=torch.from_numpy(np.stack([lb for _, lb in rows]).astype(
            np.int64)).cuda(),
        ops=torch.from_numpy(np.stack([o for o, _ in rows]).astype(
            np.uint8)).cuda() if trim else None,
        start=drives(torch.tensor([[0, int(st.n_app)]], device="cuda")),
        state={k: drives(getattr(st, k).view(1) if k in COUNTERS
                         else getattr(st, k)[None]) for k in STATE_FIELDS},
        policy={k: drives(policy[k]) for k in (
            "page_rate", "fdp_rate", "page_group0") if k in policy},
    )
    mode = dict(h=ctx.h, trace_every=1, td_mode=mcfg.td_mode,
                movement_ops=mcfg.movement_ops,
                bloom_rotate_min_writes=mcfg.bloom_rotate_min_writes)
    return inputs, mode


def run_fresh(torch, inputs, d):
    """A copy of the inputs to land one launch on: the state copied, stop
    and the trace new."""
    args = {k: v for k, v in inputs.items() if k not in ("state", "policy")}
    args["state"] = {k: v.clone() for k, v in inputs["state"].items()}
    args["policy"] = inputs["policy"]
    args["stop"] = torch.full((d, 3), -1, dtype=torch.int64, device="cuda")
    for k in ("app", "mig"):
        args[k] = torch.full((d, RUN_EVENTS), -1, dtype=torch.int32,
                             device="cuda")
    return args


def run_bytes(inputs, after, stop, mode) -> int:
    """The least bytes write_run must move for the runs it landed, each
    element read once and each written once, none twice (see
    write_run.cu). Written: every state element the runs changed, counted
    from the state before and after, read too where the new value needs
    the old (counters, fill, live, group sizes); the trace and stop. Read
    only: each event up to the one that stopped the run (lba, op), the
    map entry of each distinct page, and of each distinct page written its
    detector input (FDP rate, or two bits of each bloom filter) and, when
    it was unmapped, its layout group; the group of each distinct block
    the runs' pages left; the open block of each group written; per drive
    start, the pool, n_mig and the group flags, the surpluses under
    movement, FDP's group rates."""
    from repro_torch.core.workloads import OP_TRIM

    before = inputs["state"]
    lbas, ops, start = inputs["lbas"], inputs["ops"], inputs["start"]
    d, n = lbas.shape
    g = before["grp_size"].shape[-1]
    b = before["slot_lba"].shape[-1]
    e, td = mode["trace_every"], mode["td_mode"]
    overwritten = ("page_map", "slot_lba", "valid", "bloom_active")
    nbytes = 0
    for k, v in before.items():
        changed = int((after[k] != v).sum())
        nbytes += changed * v.element_size() * (1 if k in overwritten else 2)
    per_page = {"static": 0, "fdp": 4, "bloom": 4}[td]
    for i in range(d):
        j0, s = int(start[i, 0]), int(stop[i, 0])
        nbytes += (min(s + 1, n) - j0) * (8 + (ops is not None))
        nbytes += 8 * (s // e - j0 // e)
        pm = before["page_map"][i]
        pages = lbas[i, j0:s].unique()
        nbytes += 4 * pages.numel()
        old = pm[pages]
        nbytes += 4 * (old[old >= 0] // b).unique().numel()
        written = lbas[i, j0:s] if ops is None else lbas[i, j0:s][
            ops[i, j0:s] != OP_TRIM]
        written = written.unique()
        nbytes += per_page * written.numel()
        if ops is not None:
            nbytes += 8 * int((pm[written] < 0).sum())
        nbytes += 4 * int((after["grp_writes"][i]
                           != before["grp_writes"][i]).sum())
    per_drive = 16 + 24 + 4 + 4 + g
    per_drive += 4 * g * (bool(mode["movement_ops"]) + (td == "fdp"))
    return nbytes + d * per_drive


def time_launches(torch, args, fresh, launch, plain, plain_iters):
    """Median times of ``launch`` (unqueued and queued behind a sleep of
    the card) and of ``plain``, each call on its own ``fresh()`` copy of
    the inputs, timed alone with CUDA events."""
    times = {"kernel_ms": [], "kernel_ms_queued": [], "plain_ms": []}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(max(3, args.iters // 50)):
        calls = [("kernel_ms", launch), ("kernel_ms_queued", launch)]
        if i < plain_iters:
            calls.append(("plain_ms", plain))
        for key, fn in calls:
            run = fresh()
            torch.cuda.synchronize()
            if key == "kernel_ms_queued":  # ~0.5 ms at ~2 GHz
                torch.cuda._sleep(1_000_000)
            start.record()
            fn(run)
            end.record()
            end.synchronize()
            times[key].append(start.elapsed_time(end))
    return {**{k: float(np.median(v)) for k, v in times.items()},
            "timed_launches": len(times["kernel_ms"])}


def run_kernels(torch, args, card):
    """write_run at D = 1 and 64 in each path's configuration: exact
    against write_run_ref on the same inputs (stop, trace, every state
    field), then each launch timed alone from a fresh copy of the state,
    both with the host's cost (unqueued) and without (queued behind a
    sleep of the card)."""
    from repro_torch.kernels.write_run import kernel as wr_kernel
    from repro_torch.kernels.write_run.ref import write_run_ref

    results = {}
    for case in RUN_CASES:
        for d in (1, 64):
            inputs, mode = run_inputs(torch, args, case, d)
            got, want = run_fresh(torch, inputs, d), run_fresh(torch, inputs,
                                                              d)
            wr_kernel.write_run_cuda(**got, **mode)
            write_run_ref(**want, **mode)
            torch.cuda.synchronize()
            bad = [k for k in ("stop", "app", "mig")
                   if not torch.equal(got[k], want[k])]
            bad += [k for k, v in want["state"].items()
                    if not torch.equal(got["state"][k], v)]
            check(not bad, f"write_run {case} D={d}: kernel != plain in {bad}")
            per_drive = (got["stop"][:, 0] - inputs["start"][:, 0]).cpu()
            done = int(per_drive.sum())
            check(done > 0, f"write_run {case} D={d}: no event landed")
            # the plain version reads each element it reads on the host:
            # three timed launches at D = 1, two at 64
            ms = time_launches(
                torch, args, lambda: run_fresh(torch, inputs, d),
                lambda run: wr_kernel.write_run_cuda(**run, **mode),
                lambda run: write_run_ref(**run, **mode), 3 - (d > 1))
            nbytes = run_bytes(inputs, got["state"], got["stop"], mode)
            line = {
                "phase": "kernels", "name": "write_run", "case": case,
                "drives": d, "td_mode": mode["td_mode"],
                "op_stream": inputs["ops"] is not None,
                "warm_events": args.run_warm, "segment": RUN_EVENTS,
                "equal": True, "max_abs_err": 0,
                "events_per_launch": done,
                "longest_run": int(per_drive.max()), **ms,
                # the card's own time over the events it landed, and over
                # the longest drive's chain of dependent events
                "us_per_event": 1e3 * ms["kernel_ms_queued"] / done,
                "us_per_chain_event":
                    1e3 * ms["kernel_ms_queued"] / int(per_drive.max()),
                "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": None, "card": card,
            }
            emit(line)
            results[("write_run", case, d)] = line
            del inputs, got, want
            torch.cuda.empty_cache()
    return results


# the GC kernel's cases, from full_width's state after --run-warm writes:
# the heavy write's own GC with its group's open block full and over
# budget (decided, drained), the emergency valve (decided, drained) and a
# movement operation (as the state leaves it)
GC_MODES = ("gc", "valve", "movement")


def gc_one_inputs(torch, args, mode, d):
    """gc_one's arguments for d drives, each in the state --run-warm
    writes of full_width leave on the card (group d % groups in mode
    "gc"), and its mode keywords."""
    from repro_torch.core import simulator
    from repro_torch.kernels.gc_one.kernel import COUNTERS, STATE_FIELDS

    ctx, st, run_kw, _ = warm_drive(args, "full_width")
    policy = simulator.policy_from_config(ctx, "cuda", **run_kw)
    b = ctx.geom.pages_per_block

    def drives(t):
        return t.repeat(d, *[1] * (t.dim() - 1)).contiguous()

    state = {k: drives(getattr(st, k).view(1) if k in COUNTERS
                       else getattr(st, k)[None]) for k in STATE_FIELDS}
    g = torch.arange(d, device="cuda") % ctx.n_groups
    if mode == "gc":  # each drive's group: open block full, over budget
        rows = torch.arange(d, device="cuda")
        ab = state["active_blk"][rows, g].long()
        state["fill"][rows, ab] = b
        state["grp_alloc"][rows, g] = 0
    gc_w = policy["gc_w_greedy" if mode == "valve" else "gc_w"]
    inputs = dict(state=state, gc_w=drives(gc_w),
                  g=g if mode == "gc" else None)
    kw = dict(mode=mode, td_mode=ctx.mcfg.td_mode,
              drain=ctx.mcfg.td_mode == "static",
              gc_reserve_blocks=ctx.mcfg.gc_reserve_blocks)
    return inputs, kw


def gc_one_fresh(torch, inputs):
    """A copy of the inputs to land one launch on: the state copied, out
    new."""
    d = inputs["gc_w"].shape[0]
    return {**inputs, "state": {k: v.clone()
                                for k, v in inputs["state"].items()},
            "out": torch.full((d, 3), -1, dtype=torch.int64,
                              device="cuda")}


def gc_one_bytes(before, after, out, inputs, mode) -> int:
    """The least bytes gc_one must move for the GCs it ran, each element
    read once and each written once (see gc_one.cu). The scan: every
    block's state, the group of every CLOSED block, and for the group's
    CLOSED blocks live and each counter whose weight is nonzero (valve:
    live of every CLOSED block first). Written: every state element the
    launch changed, counted from the state before and after, read too
    where the new value needs the old (counters, fill, live, group sizes,
    erase counts); a drained victim's slots read; per drive the weights,
    g, the pool and out."""
    from repro_torch.core.ssd import CLOSED

    d = out.shape[0]
    overwritten = ("page_map", "slot_lba", "valid", "state", "group_of",
                   "stamp", "trim_dead", "active_blk", "grp_surplus")
    nbytes = 0
    for k, v in before.items():
        changed = int((signed(after[k]) != signed(v)).sum())
        nbytes += changed * v.element_size() * (1 if k in overwritten else 2)
    b = before["slot_lba"].shape[-1]
    nbytes += int(out[:, 2].sum()) * b * 5  # the victims' slots
    closed = before["state"] == CLOSED
    nbytes += before["state"].numel() + 4 * int(closed.sum())
    g = out[:, 1].clamp(min=0)
    in_g = closed & (before["group_of"] == g[:, None])
    weights = inputs["gc_w"][:, 1:].ne(0).sum(1)
    nbytes += int((in_g.sum(1) * (4 + 4 * weights)).sum())
    if mode == "valve":
        nbytes += 4 * int(closed.sum())  # the argmin over live
    return nbytes + d * (16 + 8 + 4 + 24)

def gc_one_kernels(torch, args, card):
    """gc_one at D = 1 and 64 in each mode from full_width's state: exact
    against gc_one_ref on the same inputs (out, every state field), then
    each launch timed alone from a fresh copy of the state, with the
    host's cost (unqueued) and without (queued behind a sleep)."""
    from repro_torch.kernels.gc_one import kernel as gc_one_kernel
    from repro_torch.kernels.gc_one.ref import gc_one_ref

    results = {}
    for mode in GC_MODES:
        for d in (1, 64):
            inputs, kw = gc_one_inputs(torch, args, mode, d)
            got, want = gc_one_fresh(torch, inputs), gc_one_fresh(torch,
                                                                  inputs)
            gc_one_kernel.gc_one_cuda(**got, **kw)
            gc_one_ref(**want, **kw)
            torch.cuda.synchronize()
            bad = ["out"] if not torch.equal(got["out"], want["out"]) else []
            bad += [k for k, v in want["state"].items()
                    if not torch.equal(got["state"][k], v)]
            check(not bad, f"gc_one {mode} D={d}: kernel != plain in {bad}")
            decided = int(got["out"][:, 2].sum())
            check(mode == "movement" or decided == d,
                  f"gc_one {mode} D={d}: {decided} of {d} GCs decided")
            ms = time_launches(
                torch, args, lambda: gc_one_fresh(torch, inputs),
                lambda run: gc_one_kernel.gc_one_cuda(**run, **kw),
                lambda run: gc_one_ref(**run, **kw), 3 - (d > 1))
            nbytes = gc_one_bytes(inputs["state"], got["state"], got["out"],
                                  inputs, mode)
            line = {
                "phase": "kernels", "name": "gc_one", "case": "full_width",
                "mode": mode, "drives": d, "td_mode": kw["td_mode"],
                "warm_events": args.run_warm, "decided": decided,
                "pages_moved": int((got["state"]["n_mig"]
                                    - inputs["state"]["n_mig"]).sum()),
                "equal": True, "max_abs_err": 0, **ms,
                "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": None, "card": card,
            }
            emit(line)
            results[("gc_one", mode, d)] = line
            del inputs, got, want
            torch.cuda.empty_cache()
    results[("gc_one", "gc_masked", 64)] = gc_one_masked(torch, args, card)
    return results


def gc_one_masked(torch, args, card):
    """gc_one at D = 64 in mode "gc" with every odd drive disabled (a
    fleet round's mask): exact against gc_one_ref, the disabled drives
    untouched with out (-1, -1, 0); its time queued and unqueued."""
    from repro_torch.kernels.gc_one import kernel as gc_one_kernel
    from repro_torch.kernels.gc_one.ref import gc_one_ref

    d = 64
    inputs, kw = gc_one_inputs(torch, args, "gc", d)
    inputs["enable"] = torch.arange(d, device="cuda") % 2 == 0
    got, want = gc_one_fresh(torch, inputs), gc_one_fresh(torch, inputs)
    gc_one_kernel.gc_one_cuda(**got, **kw)
    gc_one_ref(**want, **kw)
    torch.cuda.synchronize()
    bad = ["out"] if not torch.equal(got["out"], want["out"]) else []
    bad += [k for k, v in want["state"].items()
            if not torch.equal(got["state"][k], v)]
    bad += [k for k, v in inputs["state"].items()
            if not torch.equal(got["state"][k][1::2], v[1::2])]
    check(not bad, f"gc_one masked D={d}: kernel != plain in {bad}")
    check((got["out"][1::2].cpu() == torch.tensor([-1, -1, 0])).all(),
          "gc_one masked: a disabled drive's out is not (-1, -1, 0)")
    decided = int(got["out"][:, 2].sum())
    check(decided == d // 2, f"gc_one masked: {decided} of {d // 2} decided")
    ms = time_launches(
        torch, args, lambda: gc_one_fresh(torch, inputs),
        lambda run: gc_one_kernel.gc_one_cuda(**run, **kw),
        lambda run: gc_one_ref(**run, **kw), 2)
    on = inputs["enable"]
    # the enabled drives' bytes, as gc_one_bytes counts them, and one
    # enable byte and one out row for each disabled drive
    half = {k: v[on] for k, v in inputs["state"].items()}
    nbytes = gc_one_bytes(half, {k: v[on] for k, v in got["state"].items()},
                          got["out"][on], {"gc_w": inputs["gc_w"][on]},
                          "gc") + d + (d // 2) * 24
    line = {
        "phase": "kernels", "name": "gc_one", "case": "full_width",
        "mode": "gc", "drives": d, "enabled": d // 2,
        "td_mode": kw["td_mode"], "decided": decided,
        "equal": True, "max_abs_err": 0, **ms, "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "card": card,
    }
    emit(line)
    del inputs, got, want
    torch.cuda.empty_cache()
    return line


def gc_one_decide(torch, args, card):
    """gc_one under the static detector with drain=False (the reference
    drain's call: the launch only decides) at D = 1 and 64, in mode "gc"
    from full_width's state with every drive's group's open block full
    and over budget: out exact against gc_one_ref, every GC decided, the
    state untouched; times queued and unqueued."""
    from repro_torch.kernels.gc_one import kernel as gc_one_kernel
    from repro_torch.kernels.gc_one.ref import gc_one_ref

    results = {}
    for d in (1, 64):
        inputs, kw = gc_one_inputs(torch, args, "gc", d)
        kw["drain"] = False
        got, want = gc_one_fresh(torch, inputs), gc_one_fresh(torch, inputs)
        gc_one_kernel.gc_one_cuda(**got, **kw)
        gc_one_ref(**want, **kw)
        torch.cuda.synchronize()
        bad = ["out"] if not torch.equal(got["out"], want["out"]) else []
        bad += same_state(got["state"], inputs["state"])
        bad += same_state(want["state"], inputs["state"])
        check(not bad, f"gc_one decide D={d}: kernel != plain, or the "
              f"state changed, in {bad}")
        decided = int(got["out"][:, 2].sum())
        check(decided == d, f"gc_one decide D={d}: {decided} decided")
        ms = time_launches(
            torch, args, lambda: gc_one_fresh(torch, inputs),
            lambda run: gc_one_kernel.gc_one_cuda(**run, **kw),
            lambda run: gc_one_ref(**run, **kw), 3 - (d > 1))
        # the scan and out of gc_one_bytes; no victim slot is read
        b = inputs["state"]["slot_lba"].shape[-1]
        nbytes = gc_one_bytes(inputs["state"], got["state"], got["out"],
                              inputs, "gc") - decided * b * 5
        line = {
            "phase": "kernels", "name": "gc_one", "case": "full_width",
            "mode": "gc", "drain": False, "drives": d,
            "td_mode": kw["td_mode"], "decided": decided,
            "equal": True, "max_abs_err": 0, **ms, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "card": card,
        }
        emit(line)
        results[("gc_one", "decide", d)] = line
        del inputs, got, want
        torch.cuda.empty_cache()
    return results


def signed(t):
    """``t`` with a uint32 tensor viewed as int32 (a CUDA build may lack
    comparisons of uint32), any other as it is."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def same_state(a: dict, b: dict) -> list:
    """The fields of two state mappings that differ."""
    import torch

    return [k for k, v in b.items()
            if not torch.equal(signed(a[k]), signed(v))]


def gc_one_fault_inputs(torch, args, d):
    """gc_one's arguments in mode "gc" from full_width's state (each
    drive's group's open block full and over budget, so each GC drains),
    with the fault hook's state and a fault policy that retires: drive 0
    (the only one at D = 1) worn out (endurance limit 0, so the worn rate
    1.0 fails every attempt) with no spare left, so it retires and
    degrades; across 64 drives base rates 0, 0.3, 0.6 and 1.0, every
    third drive without spares, every fifth already degraded, seeds and
    draw counters spread to the top of uint32, and retries 1."""
    from repro_torch.kernels.gc_one.kernel import FAULT_FIELDS

    inputs, kw = gc_one_inputs(torch, args, "gc", d)
    _, st, _, _ = warm_drive(args, "full_width")
    i = torch.arange(d, device="cuda")
    state = inputs["state"]
    for k in FAULT_FIELDS:
        v = getattr(st, k)
        state[k] = (v[None] if v.dim() else v.view(1)).repeat(
            d, *[1] * v.dim()).contiguous()
    state["spares_left"].copy_(torch.where(i % 3 == 0, 0, 5).int())
    state["drive_status"].copy_(((i % 5 == 4)).int())
    state["degraded_at"].copy_(torch.where(i % 5 == 4, 7, -1).int())
    state["fault_draws"].view(torch.int32).copy_(
        (-1 - 977 * i).int())  # 2**32 - 1 - 977 i as uint32
    rates = torch.tensor([0.0, 0.3, 0.6, 1.0], device="cuda")
    fault_policy = {
        "fault_rate": torch.where(i == 0, 0.0, rates[i % 4]).float(),
        "fault_rate_worn": torch.ones(d, device="cuda"),
        "endurance_limit": torch.where(i % 7 == 0, 0, 2**31 - 1).int(),
        "fault_seed": (i * 2654435761) % 2**32,
    }
    inputs["fault_policy"] = fault_policy
    return inputs, {**kw, "erase_max_retries": 1}


def gc_one_faults(torch, args, card):
    """gc_one in mode "gc" with the fault hook at D = 1 and 64
    (:func:`gc_one_fault_inputs`): exact against gc_one_ref, blocks
    retired (and at D = 64 some erases kept), the drives without spares
    degraded; times queued and unqueued."""
    from repro_torch.kernels.gc_one import kernel as gc_one_kernel
    from repro_torch.kernels.gc_one.ref import gc_one_ref

    results = {}
    for d in (1, 64):
        inputs, kw = gc_one_fault_inputs(torch, args, d)
        got, want = gc_one_fresh(torch, inputs), gc_one_fresh(torch, inputs)
        gc_one_kernel.gc_one_cuda(**got, **kw)
        gc_one_ref(**want, **kw)
        torch.cuda.synchronize()
        bad = ["out"] if not torch.equal(got["out"], want["out"]) else []
        bad += same_state(got["state"], want["state"])
        check(not bad, f"gc_one faults D={d}: kernel != plain in {bad}")
        before, after = inputs["state"], got["state"]
        decided = int(got["out"][:, 2].sum())
        retired = int((after["retired_blocks"]
                       - before["retired_blocks"]).sum())
        degraded = int((after["drive_status"]
                        != before["drive_status"]).sum())
        check(decided == d, f"gc_one faults D={d}: {decided} GCs decided")
        check(retired > 0 and degraded > 0 and (d == 1 or retired < d),
              f"gc_one faults D={d}: {retired} retired, {degraded} "
              "degraded")
        ms = time_launches(
            torch, args, lambda: gc_one_fresh(torch, inputs),
            lambda run: gc_one_kernel.gc_one_cuda(**run, **kw),
            lambda run: gc_one_ref(**run, **kw), 3 - (d > 1))
        # gc_one_bytes counts the fault fields the hook changed; add the
        # per-drive policy (20 B) and the fault state it only read
        nbytes = gc_one_bytes(before, after, got["out"], inputs, "gc") \
            + d * (20 + 16)
        line = {
            "phase": "kernels", "name": "gc_one", "case": "full_width",
            "mode": "gc", "faults": True, "drives": d,
            "td_mode": kw["td_mode"], "decided": decided,
            "retired": retired, "degraded": degraded,
            "erase_max_retries": kw["erase_max_retries"],
            "equal": True, "max_abs_err": 0, **ms, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "card": card,
        }
        emit(line)
        results[("gc_one", "faults", d)] = line
        del inputs, got, want
        torch.cuda.empty_cache()
    return results


def run_halted(torch, args, card):
    """write_run with the halt guard at D = 64 in full_width's state,
    every third drive degraded: exact against write_run_ref; each degraded
    drive runs to the segment's end with its events halted (n_halted, the
    write clock, a flat trace) and nothing else changed, and each live
    drive lands what it lands without faults; times queued and
    unqueued."""
    from repro_torch.kernels.write_run import kernel as wr_kernel
    from repro_torch.kernels.write_run.ref import write_run_ref

    d = 64
    inputs, mode = run_inputs(torch, args, "full_width", d)
    halted = torch.arange(d, device="cuda") % 3 == 0
    inputs["state"]["drive_status"] = halted.int()
    inputs["state"]["n_halted"] = torch.full((d,), 5, dtype=torch.int32,
                                             device="cuda")
    fmode = {**mode, "with_faults": True}
    got, want = run_fresh(torch, inputs, d), run_fresh(torch, inputs, d)
    plain = run_fresh(torch, inputs, d)
    wr_kernel.write_run_cuda(**got, **fmode)
    write_run_ref(**want, **fmode)
    wr_kernel.write_run_cuda(**plain, **mode)  # the same drives, no faults
    torch.cuda.synchronize()
    bad = [k for k in ("stop", "app", "mig")
           if not torch.equal(got[k], want[k])]
    bad += [k for k, v in want["state"].items()
            if not torch.equal(got["state"][k], v)]
    check(not bad, f"write_run halted D={d}: kernel != plain in {bad}")
    h, live = halted.cpu(), ~halted.cpu()
    n = RUN_EVENTS
    stop, start = got["stop"].cpu(), inputs["start"].cpu()
    want_stop = torch.stack([torch.full((d,), n), start[:, 1] + n,
                             torch.zeros(d, dtype=torch.int64)], 1)
    check(torch.equal(stop[h], want_stop[h]),
          "write_run halted: a degraded drive did not run to the end")
    before = inputs["state"]
    for k, v in got["state"].items():
        want_v = before[k] + n * (k == "n_halted")
        check(torch.equal(v[halted], want_v[halted]),
              f"write_run halted: a degraded drive's {k} changed")
        if k != "n_halted":
            check(torch.equal(v[~halted], plain["state"][k][~halted]),
                  f"write_run halted: a live drive's {k} differs from its "
                  "run without faults")
    check(torch.equal(stop[live], plain["stop"].cpu()[live]),
          "write_run halted: a live drive stopped elsewhere without faults")
    app = got["app"][halted]
    check(bool((app == before["n_app"][halted][:, None]).all()),
          "write_run halted: a degraded drive's trace is not flat")
    done = int((stop[live, 0] - start[live, 0]).sum())
    ms = time_launches(
        torch, args, lambda: run_fresh(torch, inputs, d),
        lambda run: wr_kernel.write_run_cuda(**run, **fmode),
        lambda run: write_run_ref(**run, **fmode), 2)
    # the live drives' bytes as run_bytes counts them; per degraded drive
    # its trace, start, stop, status, n_halted (read and written), n_app
    # and n_mig
    sub = {"state": {k: v[~halted] for k, v in before.items()},
           "lbas": inputs["lbas"][~halted], "ops": None,
           "start": inputs["start"][~halted]}
    nbytes = run_bytes(sub, {k: v[~halted] for k, v in got["state"].items()},
                       got["stop"][~halted], mode) + 4 * int(live.sum())
    nbytes += int(h.sum()) * (8 * n + 16 + 24 + 4 + 8 + 8)
    line = {
        "phase": "kernels", "name": "write_run", "case": "full_width",
        "faults": True, "drives": d, "degraded": int(h.sum()),
        "td_mode": mode["td_mode"], "segment": n, "equal": True,
        "max_abs_err": 0, "events_per_launch": done,
        "halted_events": int(h.sum()) * n, **ms, "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "card": card,
    }
    emit(line)
    del inputs, got, want, plain
    torch.cuda.empty_cache()
    return {("write_run", "halted", d): line}


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
    results.update(run_kernels(torch, args, card))
    results.update(run_halted(torch, args, card))
    results.update(gc_one_kernels(torch, args, card))
    results.update(gc_one_faults(torch, args, card))
    results.update(gc_one_decide(torch, args, card))
    results.update(serving_kernels(torch, args, card))
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
    equiv_small_reference(torch, args, geom)


def equiv_small_reference(torch, args, geom):
    """The reference engine (fast_path=False, gc_impl="reference") at
    Geometry(4, 32, 8), a sixth of --small-writes events (it steps every
    event alone): wolf, fdp on the §6.2 swap and wolf_trim_aware on
    tpcc_churn, and a fleet of four in lock-step (static, fdp, bloom on
    tpcc_churn, and an fdp drive failing half its erase attempts with 8
    spares) on the card and on the CPU, identical."""
    from repro_torch.core import fleet, managers, workloads
    from repro_torch.core.ssd import assert_invariants

    n, lba = args.small_writes // 6 // 2 * 2, geom.lba_pages
    engine = dict(fast_path=False, gc_impl="reference")
    runs = [
        ("wolf", "two_modal", [workloads.two_modal(lba, n)]),
        ("fdp", "swap_phases", list(workloads.swap_phases(lba, n // 2))),
        ("wolf_trim_aware", "tpcc_churn", [workloads.tpcc_churn(lba, n)]),
    ]
    for preset, workload, phases in runs:
        mcfg = getattr(managers, preset)()
        t0 = time.perf_counter()
        res = {dev: managers.simulate(geom, mcfg, phases, seed=args.seed,
                                      device=dev, **engine)
               for dev in ("cuda", "cpu")}
        seconds = time.perf_counter() - t0
        label = f"equiv_small reference {preset}/{workload}"
        bad = same_run(torch, res["cuda"], res["cpu"])
        check(not bad, f"{label}: cuda != cpu in {bad}")
        assert_invariants(res["cuda"].state, label)
        emit({"phase": "equiv_small", "engine": "reference",
              "manager": mcfg.name, "workload": workload,
              "geometry": [4, 32, 8], "events": n, "identical": True,
              "wa_total": res["cuda"].wa_total,
              "erases": int(res["cuda"].state.n_erase),
              "trims": int(res["cuda"].state.n_trim),
              "host_syncs": res["cuda"].host_syncs,
              "seconds_card_and_cpu": seconds})
    specs = [
        fleet.DriveSpec(managers.wolf(), (workloads.two_modal(lba, n),), 1),
        fleet.DriveSpec(managers.fdp(), (workloads.two_modal(lba, n),), 2),
        fleet.DriveSpec(managers.wolf_dynamic(),
                        (workloads.tpcc_churn(lba, n),), 3),
        fleet.DriveSpec(managers.fdp(fault_rate=0.5, spare_blocks=8),
                        (workloads.two_modal(lba, n),), 4),
    ]
    t0 = time.perf_counter()
    res = {dev: fleet.simulate_fleet(geom, specs, sampler="numpy",
                                     device=dev, **engine)
           for dev in ("cuda", "cpu")}
    seconds = time.perf_counter() - t0
    for i in range(len(specs)):
        bad = same_run(torch, res["cuda"].result(i), res["cpu"].result(i))
        check(not bad, f"equiv_small reference fleet drive {i}: cuda != "
              f"cpu in {bad}")
    faulty = res["cuda"].state(3)
    check(int(faulty.retired_blocks) > 0,
          "equiv_small reference fleet: the faulty drive retired nothing")
    emit({"phase": "equiv_small", "engine": "reference", "fleet": True,
          "drives": [sp.label for sp in specs], "geometry": [4, 32, 8],
          "events": n, "identical": True,
          "wa": res["cuda"].wa_total.tolist(),
          "faulty": endurance_line(faulty),
          "seconds_card_and_cpu": seconds})


def zero_counts() -> None:
    """Set every kernel's launch count and the host-sync count to 0."""
    from repro_torch.core import simulator
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.gc_compact import kernel as gc_kernel
    from repro_torch.kernels.gc_one import kernel as gc_one_kernel
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.kernels.write_path import kernel as wp_kernel
    from repro_torch.kernels.write_run import kernel as wr_kernel

    wp_kernel.launches = wp_kernel.trim_launches = wr_kernel.launches = 0
    gc_kernel.launches = gc_kernel.kv_launches = 0
    gc_kernel.kv_device_launches = gc_one_kernel.launches = 0
    gc_one_kernel.demote_launches = 0
    paged_kernel.launches = flash_kernel.launches = 0
    simulator.host_syncs = simulator.rounds = simulator.interval_batches = 0
    simulator.run_stops.update(dict.fromkeys(simulator.run_stops, 0))


def read_launches() -> dict:
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.gc_compact import kernel as gc_kernel
    from repro_torch.kernels.gc_one import kernel as gc_one_kernel
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.kernels.write_path import kernel as wp_kernel
    from repro_torch.kernels.write_run import kernel as wr_kernel

    return {
        "write_run": wr_kernel.launches,
        "apply_write": wp_kernel.launches,
        "apply_trim": wp_kernel.trim_launches,
        "gc_one": gc_one_kernel.launches,
        # gc_one launches that carried the demoting drain
        "gc_one_demote": gc_one_kernel.demote_launches,
        "compact_slots": gc_kernel.launches,
        "gc_compact": gc_kernel.kv_launches,
        # gc_compact's device launches: one a call, two with hazard rows
        "gc_compact_device": gc_kernel.kv_device_launches,
        "paged_attention": paged_kernel.launches,
        "flash_attention": flash_kernel.launches,
    }


_RUNS = {}  # path -> its card RunResult, for the fleet phase


def phase_full_width(torch, args, card):
    from repro_torch.core import managers, simulator, workloads
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
    stops = dict(simulator.run_stops)
    for name in ("write_run", "gc_one"):
        check(launches[name] > 0,
              f"full_width: the main path never launched {name}")
    check(launches["apply_write"] == launches["compact_slots"] == 0,
          "full_width: a write went through the per-row apply_write, or a "
          "drain through compact_slots")
    # every heavy write's GC and movement operation is one gc_one launch,
    # and so is each valve turn
    check(launches["gc_one"] >= 2 * sum(stops.values()),
          f"full_width: {launches['gc_one']} gc_one launches for "
          f"{sum(stops.values())} heavy writes")
    assert_invariants(card_run.state, "full_width (cuda)")

    t0 = time.perf_counter()
    cpu_run = managers.simulate(geom, managers.wolf(), [phase],
                                seed=args.seed, device="cpu")
    cpu_seconds = time.perf_counter() - t0
    bad = same_run(torch, card_run, cpu_run)
    check(not bad, f"full_width: cuda != cpu in {bad}")
    check(card_run.host_syncs == cpu_run.host_syncs,
          f"full_width: {card_run.host_syncs} host syncs on the card, "
          f"{cpu_run.host_syncs} on the CPU")
    check(all(simulator.run_stops[k] == 2 * v for k, v in stops.items()),
          f"full_width: run stops {stops} on the card, "
          f"{simulator.run_stops} with the CPU's added")
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
        "runs": launches["write_run"],
        "events_per_run": args.writes / launches["write_run"],
        "erases": int(card_run.state.n_erase),
        "gc_one_per_heavy_write": launches["gc_one"] / sum(stops.values()),
        "run_stops": stops, "launches": launches, "card": card,
    }
    emit(line)
    _RUNS["full_width"] = card_run
    return line


# host syncs of the churn path at (seed, events): the rounds' and the heavy
# tail's reads (every GC, demoting ones too, is drained in its gc_one
# launch, with no read)
CHURN_SYNCS = {(0, 50_000): 3250}


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
    stops = dict(simulator.run_stops)
    for name in ("write_run", "gc_one"):
        check(launches[name] > 0,
              f"full_width_churn: the path never launched {name}")
    check(launches["apply_write"] == launches["apply_trim"] == 0,
          "full_width_churn: an event went through a per-row kernel")
    st = card_run.state
    # gc_one decides every GC and drains (demoting) in the same launch
    check(launches["gc_one_demote"] == launches["gc_one"]
          and launches["compact_slots"] == 0,
          f"full_width_churn: {launches['gc_one_demote']} demoting gc_one "
          f"launches of {launches['gc_one']}, "
          f"{launches['compact_slots']} compact_slots launches")
    want = CHURN_SYNCS.get((args.seed, n))
    check(want is None or syncs == want,
          f"full_width_churn: {syncs} host syncs, not {want}")
    assert_invariants(st, "full_width_churn (cuda)")
    check(int(st.n_trim) > 0, "full_width_churn: no TRIM landed")
    check(int(st.n_dropped) == 0, "full_width_churn: dropped writes")

    t0 = time.perf_counter()
    cpu_run = managers.simulate(geom, mcfg, phases, seed=args.seed,
                                device="cpu")
    cpu_seconds = time.perf_counter() - t0
    bad = same_run(torch, card_run, cpu_run)
    check(not bad, f"full_width_churn: cuda != cpu in {bad}")
    check(cpu_run.host_syncs == syncs,
          f"full_width_churn: {syncs} host syncs on the card, "
          f"{cpu_run.host_syncs} on the CPU")
    check(all(simulator.run_stops[k] == 2 * v for k, v in stops.items()),
          f"full_width_churn: run stops {stops} on the card, "
          f"{simulator.run_stops} with the CPU's added")
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
        "runs": launches["write_run"],
        "events_per_run": n / launches["write_run"],
        "gc_one_per_heavy_write": launches["gc_one"] / sum(stops.values()),
        "run_stops": stops, "launches": launches, "card": card,
    }
    emit(line)
    return line


# full_width_endurance's knobs: wolf_endurance (P-E limit 40, out of reach
# in a run of this length) with an age-independent floor that fails 5% of
# erases, no retry (every failed erase retires its block) and 32 spares
ENDURANCE = dict(fault_rate=0.05, erase_max_retries=0, spare_blocks=32)
# the survival curve's points, as fractions of the run
SURVIVAL_AT = (0.25, 0.5, 0.75, 1.0)


def endurance_line(st) -> dict:
    """A faulty drive's fault counters at the end of its run."""
    return {"retired": int(st.retired_blocks),
            "erase_failures": int(st.n_erase_fail),
            "spares_left": int(st.spares_left),
            "degraded_at": int(st.degraded_at),
            "halted": int(st.n_halted), "erases": int(st.n_erase)}


def phase_full_width_endurance(torch, args, card):
    """The Table-2 drive under wolf_endurance with ENDURANCE's knobs on
    full_width's stream: card then CPU, identical; blocks must retire
    and the drive degrade within the run, so the retire hook in gc_one
    and the halt guard in write_run both run at full width."""
    from repro_torch.core import managers, simulator, workloads
    from repro_torch.core.ssd import Geometry, assert_invariants

    geom = Geometry(**TABLE2)
    phase = workloads.two_modal(geom.lba_pages, args.writes, p_hot=0.9,
                                frac_hot=0.5)
    mcfg = managers.wolf_endurance(**ENDURANCE)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_run = managers.simulate(geom, mcfg, [phase], seed=args.seed,
                                 device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    stops = dict(simulator.run_stops)
    for name in ("write_run", "gc_one"):
        check(launches[name] > 0,
              f"full_width_endurance: the path never launched {name}")
    check(launches["apply_write"] == launches["compact_slots"] == 0,
          "full_width_endurance: a per-row kernel was launched")
    st = card_run.state
    assert_invariants(st, "full_width_endurance (cuda)")
    faults = endurance_line(st)
    check(faults["halted"] == args.writes - int(st.n_app),
          f"full_width_endurance: {faults}")
    if args.writes >= 100_000:  # a short run may end before any fault
        check(faults["retired"] > 0, "full_width_endurance: nothing retired")
        check(0 <= faults["degraded_at"] < args.writes,
              f"full_width_endurance: not degraded within the run: {faults}")

    t0 = time.perf_counter()
    cpu_run = managers.simulate(geom, mcfg, [phase], seed=args.seed,
                                device="cpu")
    cpu_seconds = time.perf_counter() - t0
    bad = same_run(torch, card_run, cpu_run)
    check(not bad, f"full_width_endurance: cuda != cpu in {bad}")
    check(card_run.host_syncs == cpu_run.host_syncs,
          f"full_width_endurance: {card_run.host_syncs} host syncs on the "
          f"card, {cpu_run.host_syncs} on the CPU")
    line = {
        "phase": "full_width_endurance", "manager": mcfg.name,
        "knobs": {**ENDURANCE,
                  "endurance_pe_limit": mcfg.endurance_pe_limit},
        "workload": "two_modal(p_hot=0.9, frac_hot=0.5)",
        "geometry": [TABLE2["n_luns"], TABLE2["blocks_per_lun"],
                     TABLE2["pages_per_block"]],
        "writes": args.writes, **faults,
        "degraded_at_frac": faults["degraded_at"] / args.writes,
        "identical_to_cpu": True, "invariants": True,
        "wa_total": card_run.wa_total, "intervals": int(st.interval),
        "seconds": seconds, "writes_per_s": args.writes / seconds,
        "cpu_seconds": cpu_seconds, "host_syncs": card_run.host_syncs,
        "runs": launches["write_run"], "run_stops": stops,
        "launches": launches, "card": card,
    }
    emit(line)
    _RUNS["full_width_endurance"] = card_run
    return line


def phase_fleet_endurance(torch, args, card):
    """D = 64 Table-2 drives under full_width_endurance's configuration,
    drive d with fault seed d and stream seed --seed + d, in lock-step on
    the card: drive-writes/s, rounds, the time to degrade of each drive
    and the fleet's survival fraction at four points of the run; drive 0
    equals full_width_endurance's run and drives 31 and 63 their runs
    alone on the card."""
    from repro_torch.core import analytics, fleet, managers, simulator
    from repro_torch.core import workloads
    from repro_torch.core.ssd import Geometry, assert_invariants

    geom, d = Geometry(**TABLE2), 64
    phase = workloads.two_modal(geom.lba_pages, args.writes, p_hot=0.9,
                                frac_hot=0.5)
    specs = [fleet.DriveSpec(
        managers.wolf_endurance(**ENDURANCE, fault_seed=i), (phase,),
        seed=args.seed + i) for i in range(d)]
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fleet.simulate_fleet(geom, specs, sampler="numpy")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    (meta,) = res.exec_meta
    check(launches["write_run"] == meta["rounds"],
          f"fleet_endurance: {launches['write_run']} write_run launches "
          f"for {meta['rounds']} rounds")
    check(launches["gc_one"] > 0, "fleet_endurance: no gc_one launch")
    for i in (0, 31, 63):
        assert_invariants(res.state(i), f"fleet_endurance drive {i}")
    equal = {}
    if "full_width_endurance" in _RUNS:
        bad = same_run(torch, res.result(0), _RUNS["full_width_endurance"])
        check(not bad, f"fleet_endurance drive 0 != full_width_endurance "
              f"in {bad}")
        equal["drive_0_full_width_endurance"] = True
    for i in (31, 63):
        alone = managers.simulate(geom, specs[i].mcfg, list(specs[i].phases),
                                  seed=specs[i].seed, device="cuda")
        bad = same_run(torch, res.result(i), alone)
        check(not bad, f"fleet_endurance drive {i} != its run alone in {bad}")
        equal[f"drive_{i}_alone"] = True
    ttd = res.time_to_degraded()
    points = [int(f * args.writes) for f in SURVIVAL_AT]
    survival = analytics.survival_fraction(ttd, np.array(points)).tolist()
    dead = np.sort(ttd[ttd >= 0])
    retired = res.retired_fraction()
    line = {
        "phase": "fleet_endurance", "manager": "wolf-endurance",
        "knobs": ENDURANCE, "drives": d, "writes_per_drive": args.writes,
        "geometry": [TABLE2["n_luns"], TABLE2["blocks_per_lun"],
                     TABLE2["pages_per_block"]],
        "seconds": seconds, "drive_writes_per_s": d * args.writes / seconds,
        "rounds": meta["rounds"], "interval_batches": meta["interval_batches"],
        "host_syncs": meta["host_syncs"],
        "degraded": int((res.drive_status() != 0).sum()),
        "time_to_degraded": ttd.tolist(),
        "degraded_at_min_median_max": [
            int(dead[0]), float(np.median(dead)), int(dead[-1])]
        if dead.size else None,
        "survival": dict(zip(map(str, points), survival)),
        "retired_fraction_mean": float(retired.mean()),
        "retired_fraction_max": float(retired.max()),
        "halted_events": int(sum(int(res.state(i).n_halted)
                                 for i in range(d))),
        "wa_mean": float(res.wa_total.mean()), "equal": equal,
        "launches": launches, "card": card,
    }
    emit(line)
    del res
    torch.cuda.empty_cache()
    return line


# full_width_endurance's degradation at (seed, --writes): the write it
# degrades at and the blocks it retires (R20c on the split engine)
ENDURANCE_DEGRADED = {(0, 100_000): (665, 33)}


def prefix_run(geom, mcfg, phase, n, seed, device, **engine):
    """managers.simulate's run of one phase, cut to the phase stream's
    first ``n`` events: the same drive (``build_drive``), the same seeded
    stream, then ``simulator.run`` over its first n events under the
    engine's context. Returns a RunResult."""
    from repro_torch.core import managers, simulator

    st, n_groups, assumed_p, fdp_rate, rates, pg0 = managers.build_drive(
        geom, mcfg, [phase], device=device)
    ctx = simulator.SimContext(geom, mcfg, n_groups, with_trim=phase.has_trim,
                               with_faults=mcfg.has_faults, **engine)
    rng = np.random.default_rng(seed)
    kw = dict(page_rate=rates[0], assumed_p=assumed_p, fdp_rate=fdp_rate)
    n = min(n, phase.n_writes)
    if phase.has_trim:
        ops, lbas = phase.sample_ops(rng)
        kw.update(ops=ops[:n], page_group0=pg0)
    else:
        lbas = phase.sample(rng)
    st, trace = simulator.run(ctx, st, lbas[:n], device=device, **kw)
    return managers.RunResult(trace["app"], trace["mig"], st,
                              host_syncs=trace["host_syncs"])


ORACLE_CASES = ("a", "b", "c", "d")


def phase_full_width_reference(torch, args, card):
    """The reference engine on the card at Table-2 width, held to the
    split engine on the card over the same events (traces and every
    state field exact, grp_p within 1e-6): (a) wolf on full_width's
    stream, fast_path=False and gc_impl="reference", its first
    --reference-writes writes (the fresh drive's GC burst and §5.1
    intervals); (b) wolf_dynamic on full_width_churn's stream, the same
    engine, its first --reference-churn-events events (every TRIM one
    apply_trim launch, demoting per-page drains); (c) full_width_endurance's
    configuration on (a)'s stream, its first --reference-endurance-writes
    writes (it degrades within them at the default seed and --writes);
    (d) (a) with fast_path=True (write_run's runs, the reference drain on
    the heavy writes). Each case runs in a process of its own, the four at
    once (each is host-bound); counts set to 0 just before each reference
    run and read just after, in its process; the oracle's cost is
    reported, with no claim."""
    with ProcessPoolExecutor(
            len(ORACLE_CASES),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = [pool.submit(oracle_case, args, case, card)
                for case in ORACLE_CASES]
        results = [run.result() for run in runs]
    total, lines = dict.fromkeys(read_launches(), 0), {}
    for line, launches in results:
        for k, v in launches.items():
            total[k] += v
        emit(line)
        lines[line["case"]] = line
    return {"launches": total, "cases": lines}


def oracle_case(args, case, card):
    """One case of full_width_reference, run and checked in the process
    that calls it: (its line, its reference run's launches)."""
    import torch

    from repro_torch.core import managers, workloads
    from repro_torch.core.ssd import Geometry, assert_invariants

    geom = Geometry(**TABLE2)
    two_modal = workloads.two_modal(geom.lba_pages, args.writes, p_hot=0.9,
                                    frac_hot=0.5)
    ref = dict(fast_path=False, gc_impl="reference")
    mcfg, phase, n, engine = {
        "a": lambda: (managers.wolf(), two_modal, args.reference_writes, ref),
        "b": lambda: (managers.wolf_dynamic(),
                      workloads.tpcc_churn(geom.lba_pages, args.churn_events),
                      args.reference_churn_events, ref),
        "c": lambda: (managers.wolf_endurance(**ENDURANCE), two_modal,
                      args.reference_endurance_writes, ref),
        "d": lambda: (managers.wolf(), two_modal, args.reference_writes,
                      dict(fast_path=True, gc_impl="reference")),
    }[case]()
    n = min(n, phase.n_writes)  # a quick call's shorter stream
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = prefix_run(geom, mcfg, phase, n, args.seed, "cuda", **engine)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    split = prefix_run(geom, mcfg, phase, n, args.seed, "cuda")
    label = f"full_width_reference ({case})"
    bad = same_run(torch, res, split)
    check(not bad, f"{label}: reference != split engine in {bad}")
    st = res.state
    assert_invariants(st, label)
    check(launches["gc_one"] > 0, f"{label}: no gc_one launch")
    check(launches["compact_slots"] == launches["apply_write"] == 0,
          f"{label}: a bulk drain or a per-row write ran: {launches}")
    check((launches["write_run"] > 0) == engine["fast_path"],
          f"{label}: {launches['write_run']} write_run launches")
    trims = int(st.n_trim)
    check(launches["apply_trim"] == (0 if engine["fast_path"] else trims),
          f"{label}: {launches['apply_trim']} apply_trim launches for "
          f"{trims} TRIMs")
    line = {
        "phase": "full_width_reference", "case": case,
        "manager": mcfg.name, "engine": engine, "events": n,
        "writes": int(st.n_app), "trims": trims,
        "erases": int(st.n_erase), "migrations": int(st.n_mig),
        "intervals": int(st.interval), "equal_to_split": True,
        "wa_total": res.wa_total, "seconds": seconds,
        "events_per_s": n / seconds, "host_syncs": res.host_syncs,
        "launches": {k: launches[k] for k in (
            "gc_one", "apply_trim", "write_run", "compact_slots")},
        "card": card,
    }
    if case == "b":
        check(trims > 0 and int(st.n_erase) > 0,
              f"{label}: {trims} TRIMs, {int(st.n_erase)} drains")
    if mcfg.has_faults:
        faults = endurance_line(st)
        line.update(faults)
        want = ENDURANCE_DEGRADED.get((args.seed, args.writes))
        if want is not None and n > want[0]:
            check((faults["degraded_at"], faults["retired"]) == want,
                  f"{label}: degraded at {faults['degraded_at']} with "
                  f"{faults['retired']} retired, not {want}")
    return line, launches


def phase_allocation(torch, args, card):
    """The oracle allocations of §5.5 for full_width's drive: two groups
    of half the logical pages each, updated 0.9 / 0.1, over the drive's
    OP (PBA − LBA pages): optimal_allocation (600 steps of exponentiated
    gradient) and hillclimb_allocation (blocks of 128 pages) on the card
    and on the CPU. The card's equal the CPU's (WA within rtol 1e-5 and
    the split within 1e-3 of OP for the optimum, WA within rtol 1e-6 for
    the hill climber); the optimum is no worse than the closed form (eq.
    8) and the hill climber within 0.5% of it."""
    from repro_torch.core import allocation
    from repro_torch.core.ssd import Geometry

    geom = Geometry(**TABLE2)
    lba = geom.lba_pages
    s, p = [lba / 2, lba / 2], [0.9, 0.1]
    op = float(geom.pba_pages - lba)
    out = {}
    for dev in ("cuda", "cpu"):
        ts = torch.tensor(s, dtype=torch.float32, device=dev)
        tp = torch.tensor(p, dtype=torch.float32, device=dev)
        res = {"closed_form": allocation.allocate_closed_form(ts, tp, op)}
        for name, fn in (("optimal", allocation.optimal_allocation),
                         ("hillclimb", allocation.hillclimb_allocation)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[name] = fn(ts, tp, op)
            torch.cuda.synchronize()
            res[name + "_s"] = time.perf_counter() - t0
        for name in ("closed_form", "optimal", "hillclimb"):
            res[name + "_wa"] = float(allocation.total_wa(ts, tp, res[name]))
            res[name] = res[name].cpu().tolist()
        out[dev] = res
    card_r, cpu_r = out["cuda"], out["cpu"]
    check(np.allclose(card_r["optimal_wa"], cpu_r["optimal_wa"], rtol=1e-5,
                      atol=0)
          and np.allclose(card_r["optimal"], cpu_r["optimal"], rtol=0,
                          atol=1e-3 * op),
          f"allocation: optimum on the card {card_r['optimal']} "
          f"({card_r['optimal_wa']}), on the CPU {cpu_r['optimal']} "
          f"({cpu_r['optimal_wa']})")
    check(np.allclose(card_r["hillclimb_wa"], cpu_r["hillclimb_wa"],
                      rtol=1e-6, atol=0),
          f"allocation: hill climber's WA {card_r['hillclimb_wa']} on the "
          f"card, {cpu_r['hillclimb_wa']} on the CPU")
    for r in (card_r, cpu_r):
        check(r["optimal_wa"] <= r["closed_form_wa"] + 1e-6,
              f"allocation: optimum {r['optimal_wa']} above the closed "
              f"form's {r['closed_form_wa']}")
        check(r["hillclimb_wa"] <= r["optimal_wa"] * 1.005,
              f"allocation: hill climber {r['hillclimb_wa']} not within "
              f"0.5% of the optimum {r['optimal_wa']}")
    line = {"phase": "allocation", "s": s, "p": p, "op_pages": op,
            "card_equals_cpu": True, **{f"{dev}": r for dev, r in out.items()},
            "card": card}
    emit(line)
    return line


# the mixed fleet: every sub-batch kind of the fleet, card against CPU
FLEET_MIX_GEOM = dict(n_luns=8, blocks_per_lun=64, pages_per_block=64,
                      lba_pba=0.70)


def fleet_headline_specs(args, d):
    """D Table-2 drives under wolf on two_modal(0.9, 0.5), seeds 0..D-1."""
    from repro_torch.core import fleet, managers, workloads
    from repro_torch.core.ssd import Geometry

    phase = workloads.two_modal(Geometry(**TABLE2).lba_pages, args.writes,
                                p_hot=0.9, frac_hot=0.5)
    return [fleet.DriveSpec(managers.wolf(), (phase,), seed=args.seed + i)
            for i in range(d)]


def fleet_window(torch, args, res, d):
    """A profile window of the fleet's steady state: --fleet-window more
    writes a drive on the headline fleet's final states (after --writes),
    through the simulator's batched scan: the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import managers, simulator, workloads
    from repro_torch.core.ssd import Geometry

    geom, n = Geometry(**TABLE2), args.fleet_window
    mcfg = managers.wolf()
    phase = workloads.two_modal(geom.lba_pages, n, p_hot=0.9, frac_hot=0.5)
    ctx = simulator.SimContext(geom, mcfg, len(phase.sizes))
    assumed_p, fdp_rate = managers.fdp_assumed_arrays(phase, mcfg.max_groups)
    one = simulator.policy_from_config(ctx, "cuda", assumed_p=assumed_p,
                                       fdp_rate=fdp_rate,
                                       page_rate=phase.page_rate())
    policy = simulator.stack_policies([one] * d)
    lbas = torch.as_tensor(np.stack([
        phase.sample(np.random.default_rng([args.seed, 2, i]))
        for i in range(d)]).astype(np.int64), device="cuda")
    st = res.states
    zero_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        simulator.scan_writes(ctx, st, lbas, [args.writes] * d, policy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = kernel_stats(torch, prof, wall)
    return {"writes_per_drive": n, **stats,
            "drive_writes_per_s": d * n / wall,
            "rounds": simulator.rounds,
            "interval_batches": simulator.interval_batches,
            "host_syncs": simulator.host_syncs,
            "kernels_per_round": stats["launches"] / simulator.rounds,
            "host_syncs_per_round": simulator.host_syncs / simulator.rounds}


def mixed_fleet(args):
    """(geometry, specs) of the mixed fleet, 14 drives: static (two
    seeds), a two-phase static drive,
    fdp (two seeds, and two faulty: one fails half its erase attempts
    with 8 spares, one wears out at 1 P-E cycle), single_group, bloom
    with §5.2 on writes (two seeds, and one failing half its attempts)
    and on the churn op stream (two seeds), and a trimmed static drive.
    The faulty drives run the fault hook after the demoting drain, in
    the same gc_one launch.
    """
    from repro_torch.core import fleet, managers, workloads
    from repro_torch.core.ssd import Geometry

    mgeom = Geometry(**FLEET_MIX_GEOM)
    lba, n = mgeom.lba_pages, args.fleet_mix_events
    specs = [
        fleet.DriveSpec(managers.wolf(), (workloads.two_modal(lba, n),), 1),
        fleet.DriveSpec(managers.wolf_lru(), (workloads.tpcc_like(lba, n),),
                        2),
        fleet.DriveSpec(managers.wolf(), tuple(workloads.swap_phases(
            lba, n // 2)), 3),
        fleet.DriveSpec(managers.fdp(), tuple(workloads.swap_phases(
            lba, n // 2)), 4),
        fleet.DriveSpec(managers.single_group(),
                        (workloads.uniform(lba, n),), 5),
        fleet.DriveSpec(managers.wolf_dynamic(),
                        (workloads.tpcc_like(lba, n),), 6),
        fleet.DriveSpec(managers.wolf_dynamic(),
                        (workloads.tpcc_churn(lba, n),), 7),
        fleet.DriveSpec(managers.wolf_trim_aware(), (workloads.trimmed(
            workloads.two_modal(lba, n), 0.2),), 8),
        fleet.DriveSpec(managers.fdp(), tuple(workloads.swap_phases(
            lba, n // 2)), 9),
        fleet.DriveSpec(managers.wolf_dynamic(),
                        (workloads.tpcc_like(lba, n),), 10),
        fleet.DriveSpec(managers.wolf_dynamic(),
                        (workloads.tpcc_churn(lba, n),), 11),
        fleet.DriveSpec(managers.fdp(fault_rate=0.5, spare_blocks=8,
                                     fault_seed=12),
                        tuple(workloads.swap_phases(lba, n // 2)), 12),
        fleet.DriveSpec(managers.fdp(endurance_pe_limit=1, fault_seed=13),
                        tuple(workloads.swap_phases(lba, n // 2)), 13),
        fleet.DriveSpec(managers.wolf_dynamic(fault_rate=0.5,
                                              fault_seed=14),
                        (workloads.tpcc_like(lba, n),), 14),
    ]
    return mgeom, specs


def mixed_fleet_cpu(args):
    """The mixed fleet on the CPU, in the process that calls it: (its
    exec_meta, each drive's traces and final state as plain fields that
    same_run reads, seconds)."""
    import types

    from repro_torch.core import fleet

    mgeom, specs = mixed_fleet(args)
    t0 = time.perf_counter()
    res = fleet.simulate_fleet(mgeom, specs, sampler="numpy",
                               device="cpu")
    seconds = time.perf_counter() - t0
    drives = [types.SimpleNamespace(
        app=r.app, mig=r.mig, state={k: v.clone() for k, v in
                                     r.state.items()})
        for r in map(res.result, range(len(specs)))]
    return res.exec_meta, drives, seconds


def phase_fleet(torch, args, card):
    """The fleet on the card: the headline runs (D Table-2 wolf drives in
    lock-step, numpy streams) for each D of --fleet-drives with their
    rates, rounds, interval batches, host syncs, launches and a profile
    window; D = 1 equal to full_width, three drives of D = 64 equal to
    their single-drive card runs; the device sampler at D = 64; and a
    mixed fleet of every sub-batch kind equal to its CPU run."""
    from repro_torch.core import fleet, managers, simulator, workloads
    from repro_torch.core.ssd import Geometry, assert_invariants

    geom = Geometry(**TABLE2)
    lines = {}
    for d in args.fleet_drives:
        specs = fleet_headline_specs(args, d)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fleet.simulate_fleet(geom, specs, sampler="numpy")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        (meta,) = res.exec_meta
        check(launches["write_run"] == meta["rounds"] == simulator.rounds,
              f"fleet D={d}: {launches['write_run']} write_run launches for "
              f"{meta['rounds']} rounds")
        check(launches["gc_one"] > 0, f"fleet D={d}: no gc_one launch")
        check(launches["apply_write"] == launches["compact_slots"] == 0,
              f"fleet D={d}: a per-row kernel was launched")
        check(meta["interval_batches"] == args.writes // meta["h"],
              f"fleet D={d}: {meta['interval_batches']} interval batches, "
              f"not {args.writes // meta['h']}")
        for i in sorted({0, d // 2, d - 1}):
            assert_invariants(res.state(i), f"fleet D={d} drive {i}")
        wa = res.wa_total
        check(np.isfinite(wa).all() and (wa >= 1.0).all(),
              f"fleet D={d}: WA {wa.min()}..{wa.max()}")
        equal = {}
        if d == 1 and "full_width" in _RUNS:
            bad = same_run(torch, res.result(0), _RUNS["full_width"])
            check(not bad, f"fleet D=1 != full_width in {bad}")
            equal["full_width"] = True
        if d == 64:
            for i in (0, 31, 63):
                alone = managers.simulate(geom, specs[i].mcfg,
                                          list(specs[i].phases),
                                          seed=specs[i].seed, device="cuda")
                bad = same_run(torch, res.result(i), alone)
                check(not bad, f"fleet D=64 drive {i} != its run alone in "
                      f"{bad}")
                equal[f"drive_{i}_alone"] = True
        line = {
            "phase": "fleet", "case": "headline", "manager": "wolf",
            "workload": "two_modal(p_hot=0.9, frac_hot=0.5)",
            "geometry": [TABLE2["n_luns"], TABLE2["blocks_per_lun"],
                         TABLE2["pages_per_block"]],
            "drives": d, "writes_per_drive": args.writes,
            "sampler": "numpy", "seconds": seconds,
            "drive_writes_per_s": d * args.writes / seconds,
            "rounds": meta["rounds"],
            "interval_batches": meta["interval_batches"],
            "host_syncs": meta["host_syncs"], "h": meta["h"],
            "launches": launches,
            "heavy_writes": sum(simulator.run_stops.values()),
            "wa_mean": float(wa.mean()), "wa_min": float(wa.min()),
            "wa_max": float(wa.max()), "equal": equal,
            "window": fleet_window(torch, args, res, d),
            "card": card,
        }
        emit(line)
        lines[d] = line
        if d == 64:
            numpy_wa = float(wa.mean())
        del res
        torch.cuda.empty_cache()

    if 64 in args.fleet_drives:  # the device sampler at D = 64
        specs = fleet_headline_specs(args, 64)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fleet.simulate_fleet(geom, specs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for i in range(64):
            assert_invariants(res.state(i), f"fleet device sampler drive {i}")
        wa = float(res.wa_total.mean())
        check(abs(wa - numpy_wa) <= 0.02 * numpy_wa,
              f"fleet device sampler: mean WA {wa}, numpy's {numpy_wa}")
        (meta,) = res.exec_meta
        emit({"phase": "fleet", "case": "device_sampler", "drives": 64,
              "writes_per_drive": args.writes, "seconds": seconds,
              "drive_writes_per_s": 64 * args.writes / seconds,
              "rounds": meta["rounds"],
              "interval_batches": meta["interval_batches"],
              "host_syncs": meta["host_syncs"], "wa_mean": wa,
              "wa_mean_numpy": numpy_wa, "invariants": True, "card": card})
        del res
        torch.cuda.empty_cache()

    # the mixed fleet: its CPU run in a process of its own, beside the
    # card's (each is host-bound)
    mgeom, specs = mixed_fleet(args)
    n = args.fleet_mix_events
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_run = pool.submit(mixed_fleet_cpu, args)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_res = fleet.simulate_fleet(mgeom, specs, sampler="numpy")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        cpu_meta, cpu_drives, cpu_seconds = cpu_run.result()
    for name in ("write_run", "gc_one", "gc_one_demote"):
        check(launches[name] > 0, f"fleet mixed: no {name} launch")
    check(launches["compact_slots"] == 0,
          "fleet mixed: a drain went through compact_slots")
    # static 3, fdp 4, bloom 3 and 2, single_group 1, trimmed static 1
    check(sorted(m["drives"] for m in card_res.exec_meta)
          == [1, 1, 2, 3, 3, 4],
          f"fleet mixed: sub-batches {card_res.exec_meta}")
    check(card_res.exec_meta == cpu_meta,
          f"fleet mixed: {card_res.exec_meta} on the card, "
          f"{cpu_meta} on the CPU")
    for i in range(len(specs)):
        bad = same_run(torch, card_res.result(i), cpu_drives[i])
        check(not bad, f"fleet mixed drive {i}: cuda != cpu in {bad}")
        assert_invariants(card_res.state(i), f"fleet mixed drive {i}")
    faulty = [i for i, sp in enumerate(specs) if sp.mcfg.has_faults]
    if n >= 20_000:  # a short run may end before any fault
        check(all(int(card_res.state(i).retired_blocks) > 0
                  for i in faulty),
              "fleet mixed: a faulty drive retired nothing")
    emit({"phase": "fleet", "case": "mixed", "drives": len(specs),
          "faulty": {specs[i].label: endurance_line(card_res.state(i))
                     for i in faulty},
          "geometry": [mgeom.n_luns, mgeom.blocks_per_lun,
                       mgeom.pages_per_block],
          "events_per_drive": n, "sub_batches": card_res.exec_meta,
          "identical_to_cpu": True, "seconds": seconds,
          "cpu_seconds": cpu_seconds, "launches": launches,
          "wa": card_res.wa_total.tolist(), "card": card})
    # the main path's launches: the headline runs'
    return {"launches": {k: sum(line["launches"][k] for line in
                                lines.values())
                         for k in next(iter(lines.values()))["launches"]},
            "by_drives": lines}


def serve_engine(torch, args, cfg, device, n_requests, max_new):
    """A ServingEngine with the request set submitted."""
    from repro_torch.serving.engine import Request, ServingEngine

    eng = ServingEngine(cfg, seed=args.seed, device=device, **SERVE)
    rng = np.random.default_rng(args.seed)
    for rid in range(n_requests):
        eng.submit(Request(
            rid=rid, prompt=rng.integers(0, cfg.vocab, SERVE_PROMPT).astype(
                np.int32),
            max_new=max_new, policy=SERVE_POLICIES[rid % 3]))
    return eng


_CPU_CONTROL = {}  # (seed, requests, max_new) -> the CPU smoke run's plane


def cpu_control_plane(torch, args, n_req, max_new):
    """The request set's control plane (steps, appended, copied, every
    move list) from a run at smoke width on the CPU, made once a call: the
    manager never sees the model, so the plane does not depend on the arch
    (tests/test_torch_moe.py::test_engine_control_plane_does_not_depend_on_the_model)
    and every serving path is held to the same run. Returns (plane, the
    seconds it took here, 0 where an earlier phase made it)."""
    from repro_torch.models.registry import get_config, smoke_config

    key = (args.seed, n_req, max_new)
    if key in _CPU_CONTROL:
        return _CPU_CONTROL[key], 0.0
    t0 = time.perf_counter()
    ref = serve_engine(torch, args, smoke_config(get_config(SERVE_ARCH)),
                       "cpu", n_req, max_new)
    lists = []
    while ref.running or ref.queue:
        lists.extend(ref.step()["move_lists"])
    _CPU_CONTROL[key] = ({"steps": ref.steps,
                          "appended": ref.manager.appended,
                          "copied": ref.manager.copied}, lists)
    return _CPU_CONTROL[key], time.perf_counter() - t0


def serve_path(torch, args, card, phase, arch):
    """``arch`` at full width in bf16 through the serving engine, counts
    set to 0 just before: tokens/s, step and prefill times, launches and
    memory; its control plane held to the CPU smoke run's."""
    from repro_torch.models.registry import get_config

    cfg = get_config(arch)
    n_req, max_new = SERVE_REQUESTS, SERVE_NEW
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = serve_engine(torch, args, cfg, "cuda", n_req, max_new)
    weights_gb = sum(t.numel() * t.element_size()
                     for t in eng.params.parameters()) / 1e9
    pool_gb = sum(t.numel() * t.element_size()
                  for t in eng.pools.values()) / 1e9

    # each step: the admissions (slot reservation and prefill) timed on
    # their own, then the decode step, which admits no more and ends in a
    # host read of the next tokens; a device-side finiteness flag
    admit_s, admitted, step_ms, lists = 0.0, 0, [], []
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.running or eng.queue:
        t1 = time.perf_counter()
        n = eng.admit()
        if n:
            torch.cuda.synchronize()
            admit_s += time.perf_counter() - t1
            admitted += n
        t1 = time.perf_counter()
        info = eng.step()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        lists.extend(info["move_lists"])
        if info["logits"] is not None:
            finite.logical_and_(torch.isfinite(info["logits"]).all())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    mgr = eng.manager
    mgr.check_invariants()
    check(bool(finite), f"{phase}: non-finite logits")
    check(len(mgr.free) == mgr.n_blocks,
          f"{phase}: {len(mgr.free)} of {mgr.n_blocks} blocks free")
    decode_tokens = mgr.appended - n_req * SERVE_PROMPT
    check(launches["paged_attention"] == cfg.n_layers * eng.steps,
          f"{phase}: paged_attention launched "
          f"{launches['paged_attention']} times in {eng.steps} steps")
    check(launches["gc_compact"] == len(lists),
          f"{phase}: gc_compact launched {launches['gc_compact']} "
          f"times for {len(lists)} move lists")
    for name in ("paged_attention", "gc_compact"):
        check(launches[name] > 0, f"{phase}: never launched {name}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = {"steps": eng.steps, "appended": mgr.appended,
               "copied": mgr.copied}
    del eng
    torch.cuda.empty_cache()

    (ref_summary, ref_lists), cpu_s = cpu_control_plane(torch, args, n_req,
                                                        max_new)
    check(summary == ref_summary and lists == ref_lists,
          f"{phase}: control plane {summary} differs from the CPU smoke "
          f"run's {ref_summary}")
    decode_s = sum(step_ms) / 1e3
    line = {
        "phase": phase, "arch": cfg.arch_id, "dtype": cfg.dtype,
        "layers": cfg.n_layers, "d_model": cfg.d_model,
        "q_heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "experts": cfg.n_experts, "top_k": cfg.top_k, **SERVE,
        "requests": n_req, "prompt": SERVE_PROMPT, "max_new": max_new,
        **summary, "move_lists": len(lists),
        "wa": mgr.write_amplification,
        "free_blocks_at_end": len(mgr.free),
        "control_plane_equals_cpu_smoke": True, "invariants": True,
        "seconds": seconds, "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / decode_s,
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        # admission: the prompt's slot reservation and its prefill pass
        "prefill_ms_per_request": 1e3 * admit_s / admitted,
        "launches": launches, "weights_gb": weights_gb, "kv_pool_gb": pool_gb,
        "peak_memory_gb": peak_gb, "cpu_smoke_seconds": cpu_s, "card": card,
    }
    emit(line)
    return line


def phase_serve_full_width(torch, args, card):
    """internlm2-1.8b at full width in bf16 through the serving engine."""
    return serve_path(torch, args, card, "serve_full_width", SERVE_ARCH)


def phase_serve_moe(torch, args, card):
    """olmoe-1b-7b at full width and depth in bf16 through the serving
    engine: each prefill (one request, 256 tokens: one group, capacity 40)
    takes the MoE capacity path, each decode step the dense path."""
    return serve_path(torch, args, card, "serve_moe", MOE_ARCH)


MOE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # atol = rtol, elementwise


def moe_case(torch, args, cfg, path, tokens, card):
    """One MoE layer of ``cfg`` on the card and on the CPU, the same
    weights (made on the card from --seed) and inputs: routed once on the
    CPU, that routing fed to ``path``'s dispatch, experts and combine on
    both; the card must agree within 1e-5 (fp32) or 2e-2 (bf16) and drop
    the same (token, choice) pairs. The card's own routing is reported:
    how many tokens' top-k sets differ from the CPU's (top-k is
    discontinuous, so a count, not a check)."""
    from repro_torch.models import moe

    tol = MOE_TOL[cfg.dtype]
    layer = moe.MoE(cfg, "cuda")
    layer.init_(torch.Generator(device="cuda").manual_seed(args.seed))
    layer_cpu = moe.MoE(cfg, "cpu")
    layer_cpu.load_state_dict({k: v.cpu()
                               for k, v in layer.state_dict().items()})
    rng = np.random.default_rng(args.seed + tokens)
    x_cpu = torch.from_numpy(rng.normal(size=(1, tokens, cfg.d_model)).astype(
        np.float32)).to(getattr(torch, cfg.dtype))
    x = x_cpu.cuda()
    gates, idx = moe._router(layer_cpu, x_cpu.reshape(tokens, -1), cfg)
    ggates, gidx = gates.cuda(), idx.cuda()
    if path == "capacity":
        def card_fn():
            return moe.capacity_from_routing(layer, x, ggates, gidx, cfg)
        want, keep_cpu = moe.capacity_from_routing(layer_cpu, x_cpu, gates,
                                                   idx, cfg)
        got, keep = card_fn()
        keep = keep.cpu()
        check(torch.equal(keep, keep_cpu),
              f"moe_layer {cfg.arch_id} {cfg.dtype} T {tokens}: the card "
              f"kept other (token, choice) pairs than the CPU")
        dropped = int((~keep).sum())
    else:
        def card_fn():
            return moe.dense_from_routing(layer, x, ggates, gidx, cfg)
        want = moe.dense_from_routing(layer_cpu, x_cpu, gates, idx, cfg)
        got, dropped = card_fn(), 0
    got, want = got.cpu().float(), want.float()
    err = (got - want).abs().max().item()
    check(bool(((got - want).abs() <= tol + tol * want.abs()).all()),
          f"moe_layer {cfg.arch_id} {cfg.dtype} {path} T {tokens}: card vs "
          f"CPU max abs err {err} (atol = rtol = {tol})")
    _, card_idx = moe._router(layer, x.reshape(tokens, -1), cfg)
    differ = int((card_idx.sort(-1)[0].cpu() != idx.sort(-1)[0]).any(
        -1).sum())
    apply = (moe.moe_apply_dense if path == "dense"
             else moe.moe_apply_capacity)
    line = {
        "phase": "moe_layer", "arch": cfg.arch_id, "dtype": cfg.dtype,
        "path": path, "tokens": tokens, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "experts": cfg.n_experts, "top_k": cfg.top_k,
        "tokens_per_group": moe.tokens_per_group(cfg, tokens),
        "capacity": (moe.capacity(cfg, moe.tokens_per_group(cfg, tokens))
                     if path == "capacity" else None),
        "dropped": dropped, "max_abs_err": err,
        "bound": f"atol = rtol = {tol}",
        "card_routing_sets_differ": differ,
        "routed_ms": time_ms(torch, card_fn, 20),
        "layer_ms": time_ms(torch, lambda: apply(layer, x, cfg), 20),
        "card": card,
    }
    emit(line)
    del layer, layer_cpu
    torch.cuda.empty_cache()
    return line


def phase_moe_layer(torch, args, card):
    """One MoE layer at olmoe-1b-7b's full width (d 2048, f 1024, 64
    experts, top-8) in fp32 and bf16: the capacity path at T = 256 (one
    group) and 600 (three, 168 pad rows), the dense path at T = 32 (a
    decode batch); then mixtral-8x22b's width (d 6144, f 16384, 8 experts,
    top-2) in fp32 at T = 256."""
    import dataclasses

    from repro_torch.models.registry import get_config

    check(not torch.backends.cuda.matmul.allow_tf32,
          "moe_layer: fp32 matmuls must not run in TF32")
    lines = []
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(MOE_ARCH), dtype=dtype)
        for path, tokens in (("capacity", 256), ("capacity", 600),
                             ("dense", 32)):
            lines.append(moe_case(torch, args, cfg, path, tokens, card))
    # olmoe's capacity of 40 against a mean load of 32 drops tokens;
    # mixtral's 80 against 64 may not, at its published capacity factor
    check(all(ln["dropped"] > 0 for ln in lines if ln["path"] == "capacity"),
          "moe_layer: an olmoe capacity case dropped nothing")
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), dtype="float32")
    lines.append(moe_case(torch, args, cfg, "capacity", 256, card))
    return lines


def phase_vlm_prefill(torch, args, card):
    """llava-next-34b at full width in fp32, 8 of its 60 layers: two
    sequences of 512 stub patch embeddings and 1,536 text tokens
    (``_seq_split(cfg, 2048)``), prefilled with decode headroom (the flash
    kernel at G = 7), then four decode steps; each step's logits must
    equal the last-token logits of a prefill over the sequence extended to
    that token, within 2e-3 (a dense stack: no capacity drops)."""
    import dataclasses

    from repro_torch.models import transformer
    from repro_torch.models.registry import _seq_split, get_config

    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS,
                              dtype="float32")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "vlm_prefill: fp32 matmuls must not run in TF32")
    b, n_steps = 2, 4
    s_img, s_text = _seq_split(cfg, VLM_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg)
    weights_gb = sum(t.numel() * t.element_size()
                     for t in params.parameters()) / 1e9
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s_text + n_steps)).astype(np.int32)).cuda()
    # stub patch embeddings at the JAX package's test scale (normal x 0.02)
    extra = torch.from_numpy((rng.normal(size=(b, s_img, cfg.d_model))
                              * 0.02).astype(np.float32)).cuda()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(params, tokens[:, :s_text], cfg,
                                        extra_embeds=extra,
                                        max_len=VLM_SEQ + n_steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), "vlm_prefill: non-finite logits")
    launches = read_launches()
    check(launches["flash_attention"] == cfg.n_layers,
          f"vlm_prefill: the prefill launched flash_attention "
          f"{launches['flash_attention']} times, not {cfg.n_layers}")
    decode_ms, steps = [], []
    for i in range(n_steps):
        pos = torch.full((b,), VLM_SEQ + i, dtype=torch.int32, device="cuda")
        t1 = time.perf_counter()
        got, cache = transformer.decode_step(params, cache,
                                             tokens[:, s_text + i], pos, cfg)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t1) * 1e3)
        steps.append(got)
    launches = read_launches()  # the path's: one prefill, n_steps decodes
    errs = []
    for i, got in enumerate(steps):
        want, _ = transformer.prefill(params, tokens[:, :s_text + i + 1], cfg,
                                      extra_embeds=extra)
        err = (got - want).abs().max().item()
        check(bool(((got - want).abs() <= 2e-3 + 2e-3 * want.abs()).all()),
              f"vlm_prefill: decode step {i} vs extended prefill max abs "
              f"err {err}")
        errs.append(err)
    line = {
        "phase": "vlm_prefill", "arch": cfg.arch_id, "dtype": cfg.dtype,
        "layers": cfg.n_layers, "reduced": {"n_layers": [60, cfg.n_layers]},
        "d_model": cfg.d_model, "q_heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "group": cfg.n_heads // cfg.n_kv_heads,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "batch": b,
        "image_tokens": s_img, "text_tokens": s_text,
        "decode_steps": n_steps, "prefill_s": prefill_s,
        "decode_ms": decode_ms, "max_abs_err_by_step": errs,
        "max_abs_err": max(errs), "bound": "atol = rtol = 2e-3",
        "launches": launches, "weights_gb": weights_gb,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    emit(line)
    del params, cache
    torch.cuda.empty_cache()
    return line


# The last three model families, each at full width: (a) bf16 at full
# depth, random weights from --seed, timed; (b) fp32 at full depth, each
# decode step's logits against the last-token logits of a prefill over the
# extended sequence; (c) fp32 at a depth cut, the card against the CPU on
# the same weights. phase -> (arch, (a)'s batch, prompt tokens, decode
# steps, (c)'s depth cut). Whisper's 1,500 stub frames are its 30 s audio
# context after the conv frontend's stride 2, and 440 + 8 tokens its text
# context of 448.
FAMILY_PHASES = {
    "xlstm_full_width": ("xlstm-125m", 8, 1000, 16, {"n_layers": 4}),
    "hymba_full_width": ("hymba-1.5b", 4, 2048, 16, {"n_layers": 2}),
    "whisper_full_width": ("whisper-large-v3", 4, 440, 8,
                           {"n_layers": 2, "n_encoder_layers": 2}),
}
WHISPER_FRAMES = 1500
FAMILY_CPU_PROMPT = 256  # (c)'s prompt, two decode steps


def family_inputs(torch, rng, cfg, b, s, n_steps, s_enc, device):
    """Prompt and decode tokens [b, s + n_steps] and, for the audio family,
    ``s_enc`` stub frames [b, s_enc, d] (normal x 0.02, the JAX package's
    test scale) in the model's dtype: prefill's extra positional inputs."""
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s + n_steps)).astype(np.int32)).to(device)
    if cfg.frontend != "audio_frames":
        return tokens, ()
    frames = torch.from_numpy((rng.normal(size=(b, s_enc, cfg.d_model))
                               * 0.02).astype(np.float32))
    return tokens, (frames.to(device, getattr(torch, cfg.dtype)),)


def cache_leaves(cache):
    """The tensors of a cache (dicts, lists and tuples of them) in order."""
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in cache_leaves(cache[k])]
    if isinstance(cache, (list, tuple)):
        return [t for c in cache for t in cache_leaves(c)]
    return [cache]


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (1 at least)."""
    scale = max(want.abs().max().item(), 1.0)
    return (got.float().cpu() - want.float().cpu()).abs().max().item() / scale


def family_timed(torch, args, arch, b, s, n_steps, n_profiled=2):
    """(a): bf16 at full width and depth, counts set to 0 just before the
    prefill and read after the last timed decode step; then
    ``n_profiled`` more decode steps under torch.profiler (kernels a
    step, device busy time, idle share)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.registry import get_config, get_model

    cfg = get_config(arch)
    api = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(
        torch.Generator(device="cuda").manual_seed(args.seed))
    weights_gb = sum(t.numel() * t.element_size()
                     for t in params.parameters()) / 1e9
    tokens, extra = family_inputs(torch, np.random.default_rng(args.seed),
                                  cfg, b, s, n_steps + n_profiled,
                                  WHISPER_FRAMES, "cuda")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, tokens[:, :s], *extra,
                                max_len=s + n_steps + n_profiled)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(logits).all())
    decode_ms = []
    for i in range(n_steps):
        pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
        t1 = time.perf_counter()
        logits, cache = api.decode_step(params, cache, tokens[:, s + i], pos)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t1) * 1e3)
        finite &= bool(torch.isfinite(logits).all())
    launches = read_launches()
    check(finite, f"{arch}: non-finite logits in bf16")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(n_steps, n_steps + n_profiled):
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            _, cache = api.decode_step(params, cache, tokens[:, s + i], pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    stats = kernel_stats(torch, prof, wall)
    per_step = {"kernels": stats["launches"] / n_profiled,
                "device_idle_share": stats["device_idle_share"],
                "top_kernels": stats["top_kernels"]}
    if isinstance(stats["device_busy_s"], float):
        per_step["device_busy_ms"] = stats["device_busy_s"] * 1e3 / n_profiled
    line = {
        "dtype": cfg.dtype, "layers": cfg.n_layers, "batch": b,
        "prompt_tokens": s, "decode_steps": n_steps,
        "prefill_ms": prefill_ms, "decode_ms": decode_ms,
        "decode_ms_median": float(np.median(decode_ms)),
        "decode_tokens_per_s": b * n_steps / (sum(decode_ms) / 1e3),
        "weights_gb": weights_gb,
        "cache_gb": sum(t.numel() * t.element_size()
                        for t in cache_leaves(cache)) / 1e9,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "decode_profile": {"steps": n_profiled, "wall_ms_per_step":
                           wall * 1e3 / n_profiled, **per_step},
    }
    if extra:
        line["frames"] = extra[0].shape[1]
    del params, cache
    torch.cuda.empty_cache()
    return line, launches


def family_extended(torch, args, arch, s, n_steps=4, b=2):
    """(b): fp32 at full width and depth; each decode step's logits within
    atol = rtol = 2e-3 of the last-token logits of a prefill over the
    sequence extended to that token."""
    import dataclasses

    from repro_torch.models.registry import get_config, get_model

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    api = get_model(cfg)
    params = api.init_params(
        torch.Generator(device="cuda").manual_seed(args.seed))
    tokens, extra = family_inputs(torch, np.random.default_rng(args.seed + 1),
                                  cfg, b, s, n_steps, WHISPER_FRAMES, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = api.prefill(params, tokens[:, :s], *extra,
                           max_len=s + n_steps)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    errs = []
    for i in range(n_steps):
        pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
        got, cache = api.decode_step(params, cache, tokens[:, s + i], pos)
        want, _ = api.prefill(params, tokens[:, :s + i + 1], *extra)
        errs.append((got - want).abs().max().item())
        check(bool(((got - want).abs() <= 2e-3 + 2e-3 * want.abs()).all()),
              f"{arch}: fp32 decode step {i} vs extended prefill max abs "
              f"err {errs[-1]}")
    del params, cache
    torch.cuda.empty_cache()
    return {"dtype": "float32", "layers": cfg.n_layers, "batch": b,
            "prompt_tokens": s, "decode_steps": n_steps,
            "prefill_ms": prefill_ms, "max_abs_err_by_step": errs,
            "bound": "atol = rtol = 2e-3"}


def family_card_vs_cpu(torch, args, arch, cut, n_steps=2, b=2):
    """(c): fp32 at full width, depth cut to ``cut``; the same weights on
    the card and on the CPU: logits after the prefill and each decode
    step, and every cache tensor, within 1e-4 of the CPU's relative to
    each tensor's largest value."""
    import dataclasses

    from repro_torch.models.registry import get_config, get_model, params_class

    full = get_config(arch)
    cfg = dataclasses.replace(full, dtype="float32", **cut)
    api = get_model(cfg)
    card = api.init_params(
        torch.Generator(device="cuda").manual_seed(args.seed))
    host = params_class(cfg)(cfg, "cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    s = FAMILY_CPU_PROMPT
    tokens, extra = family_inputs(torch, np.random.default_rng(args.seed + 2),
                                  cfg, b, s, n_steps,
                                  s // cfg.encoder_seq_ratio, "cpu")
    runs = {}
    for dev, params in (("cuda", card), ("cpu", host)):
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, tokens[:, :s].to(dev),
                                    *(e.to(dev) for e in extra),
                                    max_len=s + n_steps)
        steps = [logits]
        for i in range(n_steps):
            pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
            logits, cache = api.decode_step(params, cache,
                                            tokens[:, s + i].to(dev), pos)
            steps.append(logits)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = (steps, cache_leaves(cache), time.perf_counter() - t0)
    logit_errs = [rel_err(g, w) for g, w in zip(runs["cuda"][0],
                                                runs["cpu"][0])]
    check(len(runs["cuda"][1]) == len(runs["cpu"][1]),
          f"{arch}: card and CPU caches differ in structure")
    cache_errs = [rel_err(g, w) for g, w in zip(runs["cuda"][1],
                                                runs["cpu"][1])]
    worst = max(logit_errs + cache_errs)
    check(worst <= 1e-4, f"{arch}: card vs CPU relative err {worst}")
    del card, host
    torch.cuda.empty_cache()
    return {"dtype": "float32", "layers": cfg.n_layers,
            "encoder_layers": cfg.n_encoder_layers, "batch": b,
            "prompt_tokens": s, "decode_steps": n_steps,
            "logits_rel_err_by_step": logit_errs,
            "cache_tensors": len(cache_errs),
            "cache_max_rel_err": max(cache_errs), "max_rel_err": worst,
            "bound": "1e-4 of each tensor's largest value",
            "card_s": runs["cuda"][2], "cpu_s": runs["cpu"][2],
            "reduced": {k: [getattr(full, k), v] for k, v in cut.items()}}


def family_phase(torch, args, card, phase):
    """One model family at full width on the card: (a), (b) and (c) above.
    The path launches no hand-written kernel, as the JAX package routes
    it: its attention certifies no static window (no flash kernel) and
    there is no paged cache (no paged_attention); both counts must stay 0
    through the whole phase."""
    from repro_torch.models.registry import get_config

    arch, b, s, n_steps, cut = FAMILY_PHASES[phase]
    check(not torch.backends.cuda.matmul.allow_tf32,
          f"{phase}: fp32 matmuls must not run in TF32")
    timed, launches = family_timed(torch, args, arch, b, s, n_steps)
    extended = family_extended(torch, args, arch, s)
    versus = family_card_vs_cpu(torch, args, arch, cut)
    after = read_launches()
    for name in ("flash_attention", "paged_attention"):
        check(launches[name] == 0 and after[name] == 0,
              f"{phase}: {name} launched on a path that routes none")
    cfg = get_config(arch)
    line = {
        "phase": phase, "arch": arch, "family": cfg.family,
        "d_model": cfg.d_model, "q_heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        **timed, "launches": launches,
        "fp32_decode_vs_prefill": extended, "card_vs_cpu": versus,
        "reduced": {"card_vs_cpu": versus["reduced"]}, "card": card,
    }
    emit(line)
    return line


# -- training ---------------------------------------------------------------------
#
# train_full_width: internlm2-1.8b at full width and depth in bf16, random
# weights from --seed, TokenStream batches of TRAIN_BATCH x TRAIN_SEQ in
# TRAIN_MICRO microbatches, TRAIN_STEPS steps of make_train_step. No
# runner: a full-width checkpoint (bf16 params, fp32 m, v, master) would
# write ~25 GB.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 512, 2, 10
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ, TRAIN_CPU_LAYERS = 2, 256, 2
TRAIN_FAMILY_SHAPE = (2, 32)  # train_families' batch and sequence
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "param": 1e-5}
# the compared step's AdamW: at step 1 Adam moves each element with a
# gradient by about lr (m / sqrt(v) = sign(g)), 100 times TRAIN_TOL's
# param bound, so an update that is missing or wrong fails it
TRAIN_VERSUS_OPT = {"lr": 1e-3, "warmup_steps": 0}
# the op count of a full-width step on the card against its count on meta
COUNT_TOL = {"bytes": 0.01, "peak": 0.10}
DRYRUN_JOIN_S = 600  # the longest the summary waits for the dry-run sweep


BACKWARD_RANGE = "flash_attention.backward"  # kernels/flash_attention/ops.py


def attention_backward_ms(torch, cfg, b, s, iters=20):
    """ms of one flash_attention backward at the training shape (the plain
    chunked attention's recompute and its gradient), CUDA events."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    dt = getattr(torch, cfg.dtype)
    q = torch.randn(b, s, cfg.n_heads, cfg.d_head, device="cuda").to(dt)
    k, v = (torch.randn(b, s, cfg.n_kv_heads, cfg.d_head,
                        device="cuda").to(dt) for _ in range(2))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = flash_attention(q, k, v, causal=True)
    g = torch.randn_like(out)
    return time_ms(torch, lambda: torch.autograd.grad(
        out, (q, k, v), g, retain_graph=True), iters)


def phase_train_full_width(torch, args, card):
    """The trainer's main path at full width: counts set to 0 just before
    the first step and read after the last; every parameter's gradient
    finite and not all zero after step 1 (its first moment m = 0.1 ·
    clip · g says so); then one more step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig, TokenStream, to_device
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_loop import (
        TrainConfig,
        init_state,
        make_train_step,
    )

    cfg = get_config(SERVE_ARCH)
    api = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(api, torch.Generator(device="cuda").manual_seed(
        args.seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    named = dict(state["params"].named_parameters())
    n_params = sum(p.numel() for p in named.values())
    n_embed = named["embedding.embed"].numel()
    tcfg = TrainConfig(
        opt=OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=100),
        n_microbatches=TRAIN_MICRO)
    step_fn = make_train_step(api, tcfg)
    stream = TokenStream(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH,
                                    seed=args.seed))
    batches = [to_device(stream.batch(i), "cuda")
               for i in range(TRAIN_STEPS + 2)]
    zero_counts()
    step_ms, metrics = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        metrics.append({k: v.item() for k, v in m.items()})
        if i == 0:
            for k, mom in state["opt"]["m"].items():
                check(bool(torch.isfinite(mom).all()),
                      f"train_full_width: gradient of {k} not finite")
                check(bool((mom != 0).any()),
                      f"train_full_width: gradient of {k} all zero")
    launches = read_launches()
    per_step = launches["flash_attention"] / TRAIN_STEPS
    want = cfg.n_layers * TRAIN_MICRO * 2
    check(per_step == want, f"train_full_width: {per_step} flash launches "
          f"a step, want {want} (layers x microbatches x forward and "
          "recompute)")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
              for m in metrics), "train_full_width: non-finite loss")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, _ = step_fn(state, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    state, counted = train_count_check(torch, cfg, tcfg, state, step_fn,
                                       batches[TRAIN_STEPS + 1])
    stats = kernel_stats(torch, prof, wall, ranges=(BACKWARD_RANGE,))
    # the range's span on the device's timeline, from the first kernel
    # launched inside it to the last
    cuda = torch.autograd.DeviceType.CUDA
    span = [e for e in prof.key_averages() if e.key == BACKWARD_RANGE
            and getattr(e, "device_type", None) == cuda]
    span_us = sum(_device_us(e) for e in span)
    busy = stats["device_busy_s"]
    n_bwd = cfg.n_layers * TRAIN_MICRO  # one backward a layer a microbatch
    bwd_ms = attention_backward_ms(torch, cfg, TRAIN_BATCH // TRAIN_MICRO,
                                   TRAIN_SEQ)
    median = float(np.median(step_ms))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # 6 N T: forward and backward products of every weight but the
    # embedding lookup, without the remat's second forward
    flops = model_flops(n_params - n_embed, tokens, "train")
    line = {
        "phase": "train_full_width", "arch": SERVE_ARCH, "dtype": cfg.dtype,
        "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
        "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "microbatches": TRAIN_MICRO, "steps": TRAIN_STEPS,
        "init_s": init_s, "step_ms": step_ms, "step_ms_median": median,
        "tokens_per_s": tokens / (median / 1e3),
        "mfu_6nt": flops / (median / 1e3) / PEAK_FLOPS[cfg.dtype],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss": [metrics[0]["loss"], metrics[-1]["loss"]],
        "grad_norm": [metrics[0]["grad_norm"], metrics[-1]["grad_norm"]],
        "lr": [metrics[0]["lr"], metrics[-1]["lr"]],
        "flash_launches_per_step": per_step,
        "gradients_finite_nonzero": len(state["opt"]["m"]),
        "launches": launches,
        "profiled_step": {
            "wall_ms": wall * 1e3, "kernels": stats["launches"],
            "device_busy_ms": busy * 1e3 if isinstance(busy, float)
            else busy,
            "device_idle_share": stats["device_idle_share"],
            "attention_backward_calls": sum(e.count for e in span),
            "attention_backward_span_ms": span_us / 1e3 if span_us
            else "not measured",
            "top_kernels": stats["top_kernels"],
        },
        "attention_backward_ms_each": bwd_ms,
        "attention_backward_step_share": bwd_ms * n_bwd / median,
        "op_count": counted,
        "card": card,
    }
    emit(line)
    del state, batches
    torch.cuda.empty_cache()
    return line


def train_count_check(torch, cfg, tcfg, state, step_fn, batch):
    """One more timed step on the card under ``utils.opcount``, beside
    ``launch.dryrun.run_cell``'s count of the same step on the meta device:
    flops equal, the flash kernel's records equal the step's launches,
    bytes within COUNT_TOL["bytes"] (the ops whose bytes differ listed),
    the meta peak within COUNT_TOL["peak"] of ``max_memory_allocated``
    over the step. Returns (state, the comparison)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.utils.opcount import OpCounter

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = flash_kernel.launches
    with OpCounter(torch.cuda.memory_allocated()) as counter:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    max_allocated = torch.cuda.max_memory_allocated()
    launched = flash_kernel.launches - launches
    card = counter.result()
    t0 = time.perf_counter()
    cell = run_cell(SERVE_ARCH, ShapeConfig(
        "train_full_width", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        kind="train"), "card", microbatches=TRAIN_MICRO, tcfg=tcfg, cfg=cfg)
    meta_s = time.perf_counter() - t0
    meta = cell["counts"]
    bytes_rel = abs(meta["bytes"] - card["bytes"]) / card["bytes"]
    peak_rel = abs(meta["peak_bytes"] - max_allocated) / max_allocated
    ops = set(card["bytes_by_op"]) | set(meta["bytes_by_op"])
    differ = {op: [card["bytes_by_op"].get(op, 0),
                   meta["bytes_by_op"].get(op, 0)] for op in sorted(ops)
              if card["bytes_by_op"].get(op) != meta["bytes_by_op"].get(op)}
    records = [c["kernels"].get("flash_attention", {}).get("calls", 0)
               for c in (card, meta)]
    line = {
        "step_ms": step_ms, "meta_trace_s": meta_s,
        "flops": [card["flops"], meta["flops"]],
        "bytes": [card["bytes"], meta["bytes"]], "bytes_rel_err": bytes_rel,
        "bytes_differ_by_op": differ,
        "peak_bytes": [max_allocated, meta["peak_bytes"]],
        "peak_rel_err": peak_rel, "flash_launches": launched,
        "flash_records": records, "bounds": COUNT_TOL,
        "roofline": cell["roofline"],
    }
    want = TRAIN_MICRO * 2 * cfg.n_layers
    check(card["flops"] == meta["flops"],
          f"train_full_width: flops on the card {card['flops']} != meta "
          f"{meta['flops']}")
    check(records == [launched, launched] and launched == want,
          f"train_full_width: flash records {records}, launches {launched}, "
          f"want {want}")
    check(bytes_rel <= COUNT_TOL["bytes"],
          f"train_full_width: bytes card vs meta {bytes_rel}: {differ}")
    check(peak_rel <= COUNT_TOL["peak"],
          f"train_full_width: meta peak {meta['peak_bytes']} against "
          f"max_memory_allocated {max_allocated}")
    return state, line


def compression_versus(torch, g_card, seed):
    """``sharding.gradient`` on the card's fp32 gradients and on their CPU
    copies, each side with a CPU generator seeded alike (so the card gets
    the CPU's noise): ``compress_tree``'s int8 payloads and scales, and
    ``error_feedback_step``'s gradients and residuals, bit for bit; and
    ``compressed_all_reduce_mean`` as one participant (no process group)
    on one leaf, bit for bit."""
    from repro_torch.sharding import gradient as G

    g_cpu = {k: g.detach().cpu() for k, g in g_card.items()}
    t0 = time.perf_counter()

    def run(grads):
        res = G.init_residual(grads)
        eff = {k: g.float() + res[k] for k, g in grads.items()}
        payload, scales = G.compress_tree(
            eff, torch.Generator().manual_seed(seed))
        restored, residual = G.error_feedback_step(
            grads, res, torch.Generator().manual_seed(seed))
        leaf = next(iter(sorted(grads)))
        mean = G.compressed_all_reduce_mean(
            grads[leaf], torch.Generator().manual_seed(seed))
        return {"payload": payload, "scale": scales, "restored": restored,
                "residual": residual, "mean": {leaf: mean}}

    card, cpu = run(g_card), run(g_cpu)
    seconds = time.perf_counter() - t0
    unequal = [f"{part}/{k}" for part in card for k in card[part]
               if not torch.equal(card[part][k].cpu(), cpu[part][k])]
    check(not unequal, f"train_card_vs_cpu: gradient compression card != "
          f"CPU in {unequal[:8]}")
    return {"leaves": len(g_card), "parts": sorted(card),
            "bit_equal": True, "seconds": seconds,
            "int8_saturated": sum(int((q.abs() == 127).sum())
                                  for q in cpu["payload"].values())}


def adamw_step(params, grads):
    """params after one AdamW step (TRAIN_VERSUS_OPT) on ``grads`` from a
    fresh state, updated in place."""
    from repro_torch.train.optimizer import OptimizerConfig, adamw_update
    from repro_torch.train.train_loop import state_from_params

    state = state_from_params(params)
    adamw_update(grads, state["opt"], dict(params.named_parameters()),
                 OptimizerConfig(**TRAIN_VERSUS_OPT))
    return dict(params.named_parameters())


def train_versus(torch, cfg, batch, seed):
    """One step on the card and on the CPU from the same weights (drawn on
    the CPU) and batch, each checked against TRAIN_TOL: the loss and every
    gradient card against CPU, every card gradient finite, and the card's
    params after its AdamW step against the CPU's AdamW applied to the
    card's gradients. Adam's first step is about lr * sign(g), so where a
    gradient is near 0 the two sides' rounding can flip an element's sign;
    the gradients are held card = CPU, the update card = CPU on the same
    gradients. Counts set to 0 just before the card's step; returns (line,
    the card's launches, the card's gradients)."""
    from repro_torch.models.registry import get_model, params_class
    from repro_torch.train.train_loop import value_and_grad

    api = get_model(cfg)
    host = params_class(cfg)(cfg, "cpu")
    host.init_(torch.Generator().manual_seed(seed))
    card = params_class(cfg)(cfg, "cuda")
    card.load_state_dict(host.state_dict())
    replay = params_class(cfg)(cfg, "cpu")
    replay.load_state_dict(host.state_dict())
    zero_counts()
    t0 = time.perf_counter()
    card.requires_grad_(True)
    l_card, g_card = value_and_grad(api, card, {k: v.cuda()
                                                for k, v in batch.items()})
    p_card = adamw_step(card, g_card)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    host.requires_grad_(True)
    l_cpu, g_cpu = value_and_grad(api, host, batch)
    cpu_s = time.perf_counter() - t0
    p_replay = adamw_step(replay, {k: g.cpu() for k, g in g_card.items()})
    loss_err = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
    start = host.state_dict()
    grad_err = param_err = move = 0.0
    for k, g in g_card.items():
        check(bool(torch.isfinite(g).all()),
              f"{cfg.arch_id}: gradient of {k} not finite on the card")
        grad_err = max(grad_err, (g.cpu() - g_cpu[k]).abs().max().item()
                       / max(g_cpu[k].abs().max().item(), 1e-30))
        got = p_card[k].detach().cpu()
        param_err = max(param_err, rel_err(got, p_replay[k].detach()))
        move = max(move, (got - start[k]).abs().max().item())
    check(loss_err <= TRAIN_TOL["loss"] and grad_err <= TRAIN_TOL["grad"]
          and param_err <= TRAIN_TOL["param"],
          f"{cfg.arch_id}: card vs CPU loss {loss_err}, gradients {grad_err}, "
          f"params {param_err}")
    check(move >= 10 * TRAIN_TOL["param"],
          f"{cfg.arch_id}: AdamW moved no parameter past {move}")
    return {"loss": l_cpu.item(), "loss_rel_err": loss_err,
            "grad_max_rel_err": grad_err, "param_max_err": param_err,
            "param_max_move": move, "opt": TRAIN_VERSUS_OPT,
            "leaves": len(g_card), "card_s": card_s, "cpu_s": cpu_s,
            "flash_launches": launches["flash_attention"]}, launches, g_card


def phase_train_card_vs_cpu(torch, args, card):
    """internlm2-1.8b at full width in fp32, depth cut to TRAIN_CPU_LAYERS:
    one step on the card (the flash kernel forward and in each block's
    recompute) and on the CPU, held to TRAIN_TOL."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, TokenStream, to_device
    from repro_torch.models.registry import get_config

    full = get_config(SERVE_ARCH)
    cfg = dataclasses.replace(full, dtype="float32",
                              n_layers=TRAIN_CPU_LAYERS)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "train_card_vs_cpu: fp32 matmuls must not run in TF32")
    batch = to_device(TokenStream(DataConfig(
        cfg.vocab, TRAIN_CPU_SEQ, TRAIN_CPU_BATCH, seed=args.seed)).batch(0),
        "cpu")
    versus, launches, g_card = train_versus(torch, cfg, batch, args.seed)
    # every leaf but the two embedding tables (three quarters of the
    # elements, the same elementwise arithmetic): the check's CPU side
    # costs ~30 s with them
    compression = compression_versus(torch, {
        k: g for k, g in g_card.items() if not k.startswith("embedding.")},
        args.seed)
    del g_card
    check(versus["flash_launches"] == 2 * cfg.n_layers,
          "train_card_vs_cpu: want one flash launch a layer forward and one "
          "in its recompute")
    line = {"phase": "train_card_vs_cpu", "arch": SERVE_ARCH,
            "dtype": "float32", "layers": cfg.n_layers,
            "batch": TRAIN_CPU_BATCH, "seq": TRAIN_CPU_SEQ, **versus,
            "bounds": TRAIN_TOL, "launches": launches,
            "gradient_compression": compression,
            "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
            "card": card}
    emit(line)
    torch.cuda.empty_cache()
    return line


def phase_train_families(torch, args, card):
    """The other nine archs at smoke_config in fp32: one step card = CPU
    within TRAIN_TOL, every gradient finite; flash launches 2 a layer where
    the arch certifies a static window (the dense, MoE and VLM families),
    0 where the JAX package routes none (xLSTM, Hymba, Whisper)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import (
        ALL_ARCHS,
        get_config,
        get_model,
        smoke_config,
    )

    b, s = TRAIN_FAMILY_SHAPE
    shape = ShapeConfig("train_families", seq_len=s, global_batch=b,
                        kind="train")
    archs, total = {}, {}
    for arch in ALL_ARCHS:
        if arch == SERVE_ARCH:
            continue
        cfg = smoke_config(get_config(arch))
        batch = get_model(cfg).make_train_batch(
            shape, torch.Generator().manual_seed(args.seed))
        versus, launches, _ = train_versus(torch, cfg, batch, args.seed)
        want = 2 * cfg.n_layers if cfg.family in ("dense", "moe", "vlm") \
            else 0
        check(versus["flash_launches"] == want,
              f"train_families {arch}: {versus['flash_launches']} flash "
              f"launches, want {want}")
        archs[arch] = {"family": cfg.family, "layers": cfg.n_layers,
                       **versus}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    line = {"phase": "train_families", "dtype": "float32", "batch": b,
            "seq": s, "archs": archs, "bounds": TRAIN_TOL,
            "launches": total, "card": card}
    emit(line)
    return line


def phase_train_runner(torch, args, card):
    """The smoke internlm2 through TrainRunner on the card: 12 steps, a
    checkpoint every 4, a failure injected at step 6: one retry, a
    recovery, the last checkpoint at 12, the restored state on the card.
    Counts set to 0 just before."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig, TokenStream, to_device
    from repro_torch.models.registry import get_config, get_model, smoke_config
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.fault_tolerance import RunnerConfig, TrainRunner
    from repro_torch.train.train_loop import (
        TrainConfig,
        init_state,
        make_train_step,
    )

    api = get_model(smoke_config(get_config(SERVE_ARCH)))
    stream = TokenStream(DataConfig(api.cfg.vocab, 64, 8, seed=args.seed))
    with tempfile.TemporaryDirectory() as d:
        runner = TrainRunner(
            make_train_step(api, TrainConfig(n_microbatches=2)),
            init_state(api, torch.Generator(device="cuda").manual_seed(
                args.seed)),
            lambda step: to_device(stream.batch(step), "cuda"),
            RunnerConfig(total_steps=12, checkpoint_every=4,
                         checkpoint_dir=d),
            failure_at=6)
        zero_counts()
        t0 = time.perf_counter()
        out = runner.run()
        seconds = time.perf_counter() - t0
        latest = ck.latest_step(d)
    launches = read_launches()
    on_card = all(t.is_cuda for _, t in ck.state_leaves(runner.state))
    check(out["final_step"] == 12 and out["retries"] == 1
          and out["recoveries"] >= 1 and latest == 12 and on_card,
          f"train_runner: {out['final_step']} steps, {out['retries']} "
          f"retries, {out['recoveries']} recoveries, latest {latest}, "
          f"state on the card {on_card}")
    line = {"phase": "train_runner", "arch": SERVE_ARCH, "config": "smoke",
            "final_step": out["final_step"], "retries": out["retries"],
            "recoveries": out["recoveries"], "stragglers": out["stragglers"],
            "latest_step": latest, "state_on_card": on_card,
            "loss": out["metrics"]["loss"].item(),
            "step_ms_median": float(np.median(runner.step_times)) * 1e3,
            "seconds": seconds, "launches": launches, "card": card}
    emit(line)
    return line


# each example's arguments on the card. fleet_sweep's wear sweep levels
# erases twice as evenly as greedy only from ~12,000 writes a drive on,
# which takes ~1.5-2 min (host-bound): it runs in a process of its own
# beside full_width_reference (the oracle, whose seconds carry no claim)
# and is waited for as soon as the oracle ends (run_beside).
EXAMPLE_ARGS = {
    "quickstart": ["--writes", "1000"],
    "ssd_experiment": ["--writes", "2000", "--blocks-per-lun", "16",
                       "--managers", "wolf,fdp,single"],
    "serve_wolf_kv": ["--requests", "6", "--max-new", "16"],
    "train_lm": ["--steps", "20"],
}
BESIDE_EXAMPLE = ("fleet_sweep", ["--writes", "12000"])


def run_beside(fn):
    """(fn(), BESIDE_EXAMPLE's run): the example runs on the card in a
    process of its own while ``fn`` runs and is waited for as soon as
    ``fn`` returns (killed if ``fn`` fails). Its run records its exit code,
    its last line, its seconds until it was waited for, and whether it was
    still running when ``fn`` returned."""
    name, argv = BESIDE_EXAMPLE
    argv = argv + ["--device", "cuda"]
    src = str(pathlib.Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *argv],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = fn()
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    running = proc.poll() is None
    text, _ = proc.communicate(timeout=900)
    lines = text.strip().splitlines()
    return out, {name: {"rc": proc.returncode, "args": argv,
                        "seconds_until_waited": time.perf_counter() - t0,
                        "running_when_fn_returned": running,
                        "own_process": True,
                        "last_line": lines[-1] if lines else ""}}


# the dry-run sweep beside the card phases: every arch x shape on these
# meshes, in this many worker processes, niced below the card phases'
# host-bound work (it needs no card)
DRYRUN_MESHES, DRYRUN_JOBS = ("card", "single", "multi"), 3
DRYRUN_DIR = pathlib.Path(__file__).resolve().parent / "reports" / \
    "dryrun_torch"


def start_dryrun():
    """Start ``python -m repro_torch.launch.dryrun --all`` over
    DRYRUN_MESHES in a process group of its own, writing each cell's record
    and its log under DRYRUN_DIR. Returns (process, log file, start time
    on the wall clock, which the records' file times are set against);
    the process group is killed if the script exits first."""
    import atexit
    import signal

    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    log = open(DRYRUN_DIR / "sweep.log", "w")
    src = str(pathlib.Path(__file__).resolve().parent / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        ["nice", "-n", "10", sys.executable, "-m",
         "repro_torch.launch.dryrun", "--all", "--force",
         "--mesh", ",".join(DRYRUN_MESHES), "--jobs", str(DRYRUN_JOBS),
         "--report-dir", str(DRYRUN_DIR)],
        env=env, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

    atexit.register(stop)
    return proc, log, time.time()


def phase_dryrun(torch, args, card, started):
    """Join the dry-run sweep (``start_dryrun``) and print one line a cell:
    arch, shape, mesh, flops, bytes, peak GB, whether it fits the card's
    80 GB, the dominant term, roofline_fraction and trace_s. Fails on any
    cell's error, a missing cell, or xlstm-125m's train_4k and prefill_32k
    cells on the card not counted."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import brief
    from repro_torch.models.registry import ALL_ARCHS

    proc, log, t0 = started
    waited = time.perf_counter()
    rc = proc.wait(timeout=DRYRUN_JOIN_S)
    waited = time.perf_counter() - waited
    log.close()
    # the sweep's own wall time: from its start to its last record
    sweep_s = max(p.stat().st_mtime for p in DRYRUN_DIR.glob("*")) - t0
    cells, errors = {}, []
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            for mesh in DRYRUN_MESHES:
                path = DRYRUN_DIR / f"{arch}__{shape}__{mesh}.json"
                check(path.exists(), f"dryrun: no record of {path.name}")
                rec = json.loads(path.read_text())
                cells[arch, shape, mesh] = rec
                line = brief(rec)
                if "error" in rec:
                    errors.append((arch, shape, mesh))
                    line["error"] = rec["error"].strip().splitlines()[-1]
                print(json.dumps({"dryrun": line}), flush=True)
    check(rc == 0 and not errors, f"dryrun: exit {rc}, cells failed: "
          f"{errors}; see {DRYRUN_DIR / 'sweep.log'}")
    for shape in ("train_4k", "prefill_32k"):
        check("roofline" in cells["xlstm-125m", shape, "card"],
              f"dryrun: xlstm-125m {shape} on the card not counted")
    card_cells = [c for (a, s, m), c in cells.items()
                  if m == "card" and "roofline" in c]
    line = {"phase": "dryrun", "cells": len(cells),
            "counted": sum("roofline" in c for c in cells.values()),
            "skipped": sum(bool(c.get("skipped")) for c in cells.values()),
            "errors": len(errors), "meshes": DRYRUN_MESHES,
            "jobs": DRYRUN_JOBS, "sweep_s": sweep_s, "join_wait_s": waited,
            "trace_s_total": sum(c["trace_s"] for c in card_cells),
            "trace_s_max": max(c["trace_s"] for c in card_cells),
            "fits_80gb_card": sum(c["memory"]["fits_hbm"]
                                  for c in card_cells),
            "report_dir": str(DRYRUN_DIR), "card": card}
    emit(line)
    return line


def phase_examples(torch, args, card, beside):
    """Each example's main on the card at EXAMPLE_ARGS (train_lm with a
    fresh checkpoint directory), one after another, counts set to 0 just
    before the first, and ``beside`` (run_beside's run of
    BESIDE_EXAMPLE): each must return 0. Output is kept to each example's
    last line."""
    import contextlib
    import importlib
    import io
    import tempfile

    zero_counts()
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        for name, argv in EXAMPLE_ARGS.items():
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            argv = argv + ["--device", "cuda"]
            if name == "train_lm":
                argv += ["--checkpoint-dir", d]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(argv)
            lines = buf.getvalue().strip().splitlines()
            runs[name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                          "args": argv, "last_line": lines[-1] if lines
                          else ""}
            check(rc == 0, f"examples: {name} returned {rc!r}: "
                  f"{runs[name]['last_line']}")
    launches = read_launches()
    for name, run in beside.items():
        runs[name] = run
        check(run["rc"] == 0, f"examples: {name} exited {run['rc']}: "
              f"{run['last_line']}")
    line = {"phase": "examples", "examples": runs, "launches": launches,
            "card": card}
    emit(line)
    return line


def phase_dense_vs_paged(torch, args, card):
    """The paged path held against the dense one at full width in fp32
    (the counterpart of tests/test_wolf_kv.py:168-268)."""
    import dataclasses

    from repro_torch.kvcache.manager import WolfKVManager
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_config
    from repro_torch.serving import paged_model

    cfg = dataclasses.replace(get_config(SERVE_ARCH), dtype="float32")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "dense_vs_paged: fp32 matmuls must not run in TF32")
    b, s, n_steps, page, n_blocks, max_pages = 2, 512, 4, 16, 160, 64
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg)
    rng = np.random.default_rng(args.seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, s + n_steps + 1)).astype(np.int32)).cuda()
    errs = []

    def close(got, want, what):  # atol = rtol = 2e-3, elementwise
        err = (got - want).abs().max().item()
        ok = bool(((got - want).abs() <= 2e-3 + 2e-3 * want.abs()).all())
        check(ok, f"dense_vs_paged {what}: paged vs dense max abs err {err}")
        errs.append(err)

    def decode_inputs(mgr):
        wb = np.zeros(b, np.int32)
        ws = np.zeros(b, np.int32)
        for j in range(b):
            wb[j], ws[j] = mgr.append_token(j)
        tables = np.stack([mgr.block_table(j, max_pages) for j in range(b)])
        valid = np.stack([mgr.slot_valid(j, max_pages)
                          for j in range(b)]).astype(np.int8)
        lengths = np.asarray([mgr.cache_len(j) for j in range(b)], np.int32)
        return [torch.from_numpy(x).cuda()
                for x in (tables, valid, lengths, wb, ws)]

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, cache = transformer.prefill(params, tokens[:, :s], cfg,
                                      max_len=s + n_steps + 1)
    mgr = WolfKVManager(n_blocks, page, 1)
    wb = np.zeros((b, s), np.int32)
    ws = np.zeros((b, s), np.int32)
    for i in range(b):
        mgr.add_sequence(i, 0)
        for t in range(s):
            wb[i, t], ws[i, t] = mgr.append_token(i)
    pools = paged_model.init_pools(cfg, n_blocks, page, "cuda")
    got, pools = paged_model.paged_prefill(
        params, cfg, pools, tokens[:, :s], torch.from_numpy(wb).cuda(),
        torch.from_numpy(ws).cuda())
    close(got, want, "prefill")
    for i in range(n_steps):
        pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
        want, cache = transformer.decode_step(params, cache,
                                              tokens[:, s + i], pos, cfg)
        got, pools = paged_model.paged_decode_step(
            params, cfg, pools, *decode_inputs(mgr), tokens[:, s + i], pos)
        close(got, want, f"decode {i}")

    # scattered evictions, a compaction of both sequences, one more decode
    evicted = [np.sort(rng.choice(s, 48, replace=False)) for _ in range(b)]
    for j in range(b):
        for ci in evicted[j]:
            mgr.evict_token(j, int(ci))
    copied = mgr.gc_group(0) + mgr.gc_group(0)
    moves = mgr.drain_moves()
    check(copied > 0 and len(moves) == copied,
          "dense_vs_paged: the compaction moved nothing")
    pools = paged_model.apply_moves(pools, moves)
    mgr.check_invariants()
    pos = torch.full((b,), s + n_steps, dtype=torch.int32, device="cuda")
    for j in range(b):
        cache["kv_pos"][j, torch.from_numpy(evicted[j]).cuda()] = -1
    want, cache = transformer.decode_step(params, cache,
                                          tokens[:, s + n_steps], pos, cfg)
    got, pools = paged_model.paged_decode_step(
        params, cfg, pools, *decode_inputs(mgr), tokens[:, s + n_steps], pos)
    close(got, want, "decode after compaction")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    check(launches["flash_attention"] == cfg.n_layers,
          f"dense_vs_paged: the dense prefill launched flash_attention "
          f"{launches['flash_attention']} times, not {cfg.n_layers}")
    for name in ("paged_attention", "gc_compact"):
        check(launches[name] > 0, f"dense_vs_paged: never launched {name}")
    line = {
        "phase": "dense_vs_paged", "arch": cfg.arch_id, "dtype": cfg.dtype,
        "batch": b, "prompt": s, "decode_steps": n_steps + 1,
        "evicted_per_seq": len(evicted[0]), "copied": copied,
        "max_abs_err_by_step": errs, "max_abs_err": max(errs),
        "bound": "atol = rtol = 2e-3", "seconds": seconds,
        "launches": launches, "card": card,
    }
    emit(line)
    del params, cache, pools
    torch.cuda.empty_cache()
    return line


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def kernel_stats(torch, prof, wall, ranges=()):
    """Device busy time, idle share, launches and the top kernels of a
    profile. ``ranges``: names of record_function ranges, whose spans the
    profiler also puts on the device's timeline; they are not kernels."""
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda
            and e.key not in ranges]
    busy_us = sum(_device_us(e) for e in kern)
    top = sorted(kern, key=_device_us, reverse=True)[:6]
    return {
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6 if kern else "not measured",
        "device_idle_share": 1 - busy_us / 1e6 / wall if kern
        else "not measured",
        "launches": sum(e.count for e in kern),
        "top_kernels": [[e.key[:80], _device_us(e) / 1e3, e.count]
                        for e in top],
    }


def phase_profile(torch, args, card):
    """Where the card's time goes on the simulator's two Table-2 paths
    (wolf on two_modal, wolf_dynamic on the tpcc_churn op stream), in two
    windows each: the first --profile-writes events of a fresh drive (GC
    at its heaviest), and ten times as many after --run-warm events (the
    steady state the default runs spend most of their events in); and on
    the serving engine's decode steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import managers, simulator, workloads
    from repro_torch.core.ssd import Geometry
    from repro_torch.models.registry import get_config

    geom = Geometry(**TABLE2)
    n = args.profile_writes
    paths = [
        ("full_width", managers.wolf(),
         workloads.two_modal(geom.lba_pages, n, p_hot=0.9, frac_hot=0.5)),
        ("full_width_churn", managers.wolf_dynamic(),
         workloads.tpcc_churn(geom.lba_pages, n)),
    ]

    def window(path, label, events, fn):
        torch.cuda.synchronize()
        # device activity only: the host-side op records are not read, and
        # collecting them costs minutes after the window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            syncs = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stats = kernel_stats(torch, prof, wall)
        emit({
            "phase": "profile", "path": path, "window": label,
            "events": events, **stats,
            "events_per_s": events / wall,
            "kernels_per_event": stats["launches"] / events,
            "host_syncs_per_event": syncs / events, "card": card,
        })

    for path, mcfg, phase in paths:
        window(path, "fresh drive", n, lambda: managers.simulate(
            geom, mcfg, [phase], seed=args.seed + 1,
            device="cuda").host_syncs)
    for path in RUN_CASES:
        ctx, st, run_kw, events = warm_drive(args, path)
        ops, lbas = events(10 * n, [args.seed, 1 << 20])
        window(path, f"after {args.run_warm} events", 10 * n,
               lambda: simulator.run(
                   ctx, st, lbas, ops=ops if ctx.with_trim else None,
                   device="cuda", **run_kw)[1]["host_syncs"])
        del st

    # decode steps of the serving engines at batch 32, after the prefills
    for path, arch in (("serve_full_width", SERVE_ARCH),
                       ("serve_moe", MOE_ARCH)):
        steps = 8
        eng = serve_engine(torch, args, get_config(arch), "cuda",
                           SERVE["max_batch"], steps + 2)
        eng.step()  # admits (prefills) every request and decodes once
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stats = kernel_stats(torch, prof, wall)
        paged = [e for e in prof.key_averages()
                 if "paged_attention_kernel" in e.key]
        check(paged, f"profile {path}: no paged_attention kernel in the "
              "decode window")
        paged_s = sum(_device_us(e) for e in paged) / 1e6
        busy = stats["device_busy_s"]
        emit({
            "phase": "profile", "path": path, "arch": eng.cfg.arch_id,
            "batch": SERVE["max_batch"], "decode_steps": steps, **stats,
            "kernels_per_step": stats["launches"] / steps,
            "paged_attention_device_s": paged_s,
            "paged_attention_launches": sum(e.count for e in paged),
            "paged_attention_busy_share": paged_s / busy
            if isinstance(busy, float) and busy > 0 else "not measured",
            "card": card,
        })
        del eng
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--writes", type=int, default=100_000)
    ap.add_argument("--churn-events", type=int, default=50_000)
    ap.add_argument("--small-writes", type=int, default=6000)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--profile-writes", type=int, default=1000)
    ap.add_argument("--run-warm", type=int, default=20_000)
    ap.add_argument("--fleet-drives", type=lambda v: [
        int(x) for x in v.split(",")], default=[1, 8, 64, 256])
    ap.add_argument("--fleet-window", type=int, default=5000)
    ap.add_argument("--fleet-mix-events", type=int, default=20_000)
    ap.add_argument("--reference-writes", type=int, default=5000)
    ap.add_argument("--reference-churn-events", type=int, default=10_000)
    ap.add_argument("--reference-endurance-writes", type=int, default=1000)
    ap.add_argument("--phases", type=lambda v: v.split(","), default=None,
                    help="run only these phases (comma-separated; the "
                    "kernel summary line needs kernels and every path)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")

    card = nvidia_smi()
    # the dry-run needs no card: it runs beside every card phase
    dryrun = (start_dryrun() if args.phases is None or "dryrun" in
              args.phases else None)
    build_s = _build.build_all()
    emit({
        "phase": "env", "nvidia_smi": card,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "kernel_build_s": build_s,
        "ptxas_sass": build_report(_build),
    })
    seconds = {}

    def timed(name, fn, *a):
        if args.phases is not None and name not in args.phases:
            return None
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
        "full_width_endurance": timed("full_width_endurance",
                                      phase_full_width_endurance, card),
        "fleet": timed("fleet", phase_fleet, card),
        "fleet_endurance": timed("fleet_endurance", phase_fleet_endurance,
                                 card),
    }
    def oracle():  # BESIDE_EXAMPLE runs beside it: its seconds carry no claim
        return timed("full_width_reference", phase_full_width_reference,
                     card)

    if args.phases is None or "examples" in args.phases:
        paths["full_width_reference"], beside = run_beside(oracle)
    else:
        paths["full_width_reference"], beside = oracle(), {}
    paths |= {
        "serve_full_width": timed("serve_full_width", phase_serve_full_width,
                                  card),
        "serve_moe": timed("serve_moe", phase_serve_moe, card),
        "dense_vs_paged": timed("dense_vs_paged", phase_dense_vs_paged, card),
        "vlm_prefill": timed("vlm_prefill", phase_vlm_prefill, card),
        **{p: timed(p, family_phase, card, p) for p in FAMILY_PHASES},
        "train_full_width": timed("train_full_width", phase_train_full_width,
                                  card),
        "train_card_vs_cpu": timed("train_card_vs_cpu",
                                   phase_train_card_vs_cpu, card),
        "train_families": timed("train_families", phase_train_families,
                                card),
        "train_runner": timed("train_runner", phase_train_runner, card),
        "examples": timed("examples", phase_examples, card, beside),
    }
    timed("moe_layer", phase_moe_layer, card)
    timed("allocation", phase_allocation, card)
    timed("profile", phase_profile, card)
    timed("dryrun", phase_dryrun, card, dryrun)
    if args.phases is not None:  # a partial run: no summary, no ok line
        print(nvidia_smi(), flush=True)
        emit({"partial": args.phases, "phase_s": seconds})
        return

    replaces = {
        "write_run": "src/repro/kernels/write_path/kernel.py:66 (apply_write)"
                     " and src/repro/kernels/write_path/kernel.py:117 "
                     "(apply_trim), on the simulator's paths",
        "gc_one": "src/repro/kernels/gc_compact/kernel.py:67 (compact_slots,"
                  " via _run) with src/repro/core/simulator.py:1172 "
                  "(_gc_one around it), on the simulator's paths",
        "apply_write": "src/repro/kernels/write_path/kernel.py:66",
        "apply_trim": "src/repro/kernels/write_path/kernel.py:117",
        "compact_slots": "src/repro/kernels/gc_compact/kernel.py:67",
        "gc_compact": "src/repro/kernels/gc_compact/kernel.py:103",
        "paged_attention": "src/repro/kernels/paged_attention/kernel.py:148",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:161",
    }
    # every case each summary row holds, the one whose times it reports
    # first: the simulator's kernels at D = 1 (its main path; write_run and
    # gc_one in full_width's state, gc_one's own GC drained), the serving
    # path's in the type its path runs them in (bf16 serving, its move
    # lists overlapping; the dense check's flash in fp32)
    cases = {
        "write_run": [(c, d) for c in RUN_CASES for d in (1, 64)]
        + [("halted", 64)],
        "gc_one": [(m, d) for m in GC_MODES for d in (1, 64)]
        + [("gc_masked", 64), ("faults", 1), ("faults", 64),
           ("decide", 1), ("decide", 64)],
        **{n: [(d,) for d in (1, 64)]
           for n in ("apply_write", "apply_trim", "compact_slots")},
        "gc_compact": [(t, c) for t in ("bfloat16", "float32")
                       for c in ("overlapping", "disjoint", MOE_ARCH)],
        "paged_attention": [(t, *a) for t in ("bfloat16", "float32")
                            for a in ((), (MOE_ARCH,))],
        "flash_attention": [(t, *a) for t in ("float32", "bfloat16")
                            for a in ((), ("mixtral-8x22b",), (VLM_ARCH,),
                                      ("train",))],
    }
    summary = []
    for name in replaces:
        first = cases[name][0]
        k1 = kernels[(name, *first)]
        by_path = {p: line["launches"][name] for p, line in paths.items()}
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "timed_case": (f"{first[0]} state, drives={first[1]}"
                           if name == "write_run" else
                           f"mode={first[0]}, drives={first[1]}"
                           if name == "gc_one" else
                           f"drives={first[0]}" if isinstance(first[0], int)
                           else ", ".join(first)),
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(kernels[(name, *c)]["max_abs_err"]
                               for c in cases[name]),
            "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "library_ms": k1["library_ms"],
        }
        if name == "write_run":
            row.update({k: k1[k] for k in (
                "kernel_ms_queued", "events_per_launch", "us_per_event")})
        if name in ("gc_one", "gc_compact", "paged_attention",
                    "flash_attention"):
            row["ms_queued"] = k1["kernel_ms_queued"]
        if name == "gc_compact":  # one device launch where no row stages
            kd = kernels[(name, first[0], "disjoint")]
            row["disjoint"] = {k: kd[k] for k in (
                "kernel_ms", "kernel_ms_queued", "bound_ms",
                "device_launches")}
        if name == "paged_attention":
            row["ms_cold"] = k1["kernel_ms_cold"]
            row["ms_cold_queued"] = k1["kernel_ms_cold_queued"]
        if name == "flash_attention":  # the model's type, beside fp32's
            row["library_ms_queued"] = k1["library_ms_queued"]
            kb = kernels[(name, "bfloat16")]
            row["bfloat16"] = {k: kb[k] for k in (
                "kernel_ms", "kernel_ms_queued", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_ms_queued", "tflops",
                "max_abs_err", "max_row_rel_err")}
        # the MoE and VLM archs' shapes, each held and timed as the first
        shapes = {", ".join(c): {k: kernels[(name, *c)][k] for k in (
            "kernel_ms", "kernel_ms_queued", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err")}
            for c in cases[name] if c[-1] in (MOE_ARCH, "mixtral-8x22b",
                                              VLM_ARCH, "train")}
        if shapes:
            row["shapes"] = shapes
        summary.append(row)
    emit({"kernels": summary, "phase_s": seconds,
          "script_s": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
