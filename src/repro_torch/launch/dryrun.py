"""Dry-run: count every (arch × shape × mesh) cell's step on the meta
device under the H100 roofline (the counterpart of
``repro.launch.dryrun``, which lowers and compiles each cell for a TPU
mesh and reads its HLO).

A cell builds the model's state and inputs on the meta device (shapes and
dtypes, nothing allocated) and runs the step under ``utils.opcount``:
for ``train`` a full step (microbatches, the backward with per-block
remat, AdamW); for ``prefill`` and ``decode`` the model's own call. The
flash kernel takes the card's route on meta and records its own cost;
the recurrences' loops count one body times their trip count.

Meshes (``--mesh``):
  card    one H100 (``n_chips`` 1, the default): flops, HBM bytes and the
          peak live bytes of the step as counted, the roofline terms, and
          whether the peak fits the card's 80 GB.
  single  the 16×16 production mesh (256 chips), and
  multi   the 2×16×16 one (512 chips): the placement's per-device bytes of
          state (or params), cache and batch (``sharding/auto.py``) and
          the analytic memory floor per device. Per-device flops, HBM
          bytes and collective bytes would need an SPMD partitioner, which
          compiled the JAX cells and which one card has none of: those
          fields are null.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-20b \
        --shape train_4k --mesh card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 4
Results land in reports/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import pathlib
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, as_completed

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import (
    ALL_ARCHS,
    get_config,
    get_model,
    params_class,
)
from repro_torch.sharding.auto import (
    auto_shardings,
    batch_shardings,
    cache_shardings,
    flatten,
    leaf_itemsize,
    leaf_shape,
    per_device_bytes,
)
from repro_torch.train.train_loop import (
    TrainConfig,
    make_train_step,
    train_state_specs,
)
from repro_torch.utils.opcount import OpCounter
from repro_torch.utils.roofline import (
    HBM_BW,
    Roofline,
    memory_floor_bytes,
    model_flops,
)

REPORT_DIR = pathlib.Path("reports/dryrun_torch")
MESH_KINDS = ("card", "single", "multi")
CARD_HBM_BYTES = 80e9  # one H100's memory


def count_params(params, cfg) -> dict:
    """(total, backbone = non-embedding, active = MoE-active backbone), the
    JAX dry-run's keys: an embedding table or positions leave the
    backbone, and an MoE model's experts count top_k / n_experts."""
    total = backbone = expert = 0
    for name, leaf in flatten(params).items():
        n = math.prod(leaf_shape(leaf))
        keys = name.split(".")
        total += n
        if any(k in ("embedding", "pos_embed") for k in keys):
            continue
        backbone += n
        if "moe" in keys and any(k in ("wi_gate", "wi_up", "wo")
                                 for k in keys):
            expert += n
    active = backbone
    if cfg.n_experts:
        active = backbone - expert + expert * (cfg.top_k / cfg.n_experts)
    return {"total": total, "backbone": backbone, "active": active}


def tree_bytes(tree) -> int:
    return sum(math.prod(leaf_shape(l)) * leaf_itemsize(l)
               for l in flatten(tree).values())


def on_meta(specs: dict) -> dict:
    """Empty meta tensors for {name: (shape, dtype)}."""
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in specs.items()}


def count_step(api, shape: ShapeConfig, *, microbatches: int = 8,
               tcfg: TrainConfig | None = None) -> dict:
    """The op count of one step of ``shape`` on the meta device, what was
    resident when it began counted in the peak."""
    cfg = api.cfg
    if shape.kind == "train":
        state = train_state_specs(api)
        batch = on_meta(api.train_batch_specs(shape))
        step = make_train_step(api, tcfg or TrainConfig(
            n_microbatches=microbatches))
        with OpCounter(tree_bytes(state) + tree_bytes(batch)) as c:
            step(state, batch)
        return c.result()
    params = params_class(cfg)(cfg, "meta")
    with torch.no_grad():
        if shape.kind == "prefill":
            inputs = on_meta(api.prefill_specs(shape))
            with OpCounter(tree_bytes(params) + tree_bytes(inputs)) as c:
                api.prefill(params, **inputs)
            return c.result()
        specs = api.decode_specs(shape)
        cache = specs.pop("cache")
        inputs = on_meta(specs)
        with OpCounter(tree_bytes(params) + tree_bytes(cache)
                       + tree_bytes(inputs)) as c:
            api.decode_step(params, cache, inputs["tokens"], inputs["pos"])
        return c.result()


def _placement(api, shape: ShapeConfig, mesh, param_sharding: str) -> dict:
    """Per-device bytes of the state (train) or params, the cache and the
    batch under the automatic placement on ``mesh``."""
    cfg = api.cfg
    if shape.kind == "train":
        state = train_state_specs(api)
        batch = api.train_batch_specs(shape)
        return {"state": per_device_bytes(auto_shardings(state, mesh),
                                          state, mesh),
                "cache": 0,
                "batch": per_device_bytes(batch_shardings(batch, mesh),
                                          batch, mesh)}
    params = params_class(cfg)(cfg, "meta")
    out = {"params": per_device_bytes(
        auto_shardings(params, mesh, mode=param_sharding), params, mesh)}
    if shape.kind == "prefill":
        inputs = api.prefill_specs(shape)
        out.update(cache=0, batch=per_device_bytes(
            batch_shardings(inputs, mesh), inputs, mesh))
        return out
    specs = api.decode_specs(shape)
    cache = specs.pop("cache")
    out.update(
        cache=per_device_bytes(cache_shardings(cache, mesh), cache, mesh),
        batch=per_device_bytes(batch_shardings(specs, mesh), specs, mesh))
    return out


def run_cell(arch: str, shape: str | ShapeConfig, mesh_kind: str = "card",
             *, microbatches: int = 8, param_sharding: str = "auto",
             tcfg: TrainConfig | None = None, cfg=None) -> dict:
    """One cell's record (the JAX cell's fields; ``trace_s`` in place of
    ``lower_s`` and ``compile_s``). ``shape`` is a name of SHAPES or a
    ShapeConfig; ``cfg`` overrides the arch's config (a cut one)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = cfg or get_config(arch)
    result = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
              "kind": shape.kind}
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"unknown mesh {mesh_kind!r}")
    if not cfg.supports_shape(shape):
        result["skipped"] = ("long_500k requires sub-quadratic attention "
                             "(as in the JAX dry-run)")
        return result
    api = get_model(cfg)
    params = params_class(cfg)(cfg, "meta")
    counts = count_params(params, cfg)
    params_bytes = tree_bytes(params)
    cache_bytes = 0
    if shape.kind != "train":
        cache_bytes = tree_bytes(api.init_cache(
            shape.global_batch, shape.seq_len, device="meta"))
    mf = model_flops(counts["active"], shape.global_batch
                     if shape.kind == "decode" else shape.tokens, shape.kind)
    if mesh_kind == "card":
        n_chips, mesh_shape = 1, {"card": 1}
    else:
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
        n_chips, mesh_shape = mesh.size, mesh.shape
    act_boundary = cfg.n_layers * shape.tokens * cfg.d_model * 2
    floor = memory_floor_bytes(
        shape.kind, params_bytes_dev=params_bytes / n_chips,
        cache_bytes_dev=cache_bytes / n_chips,
        act_boundary_bytes_dev=act_boundary / n_chips)
    result.update(n_chips=n_chips, mesh_shape=mesh_shape, overrides={
        "param_sharding": param_sharding, "microbatches": microbatches},
        params=counts)
    t0 = time.perf_counter()
    if mesh_kind == "card":
        count = count_step(api, shape, microbatches=microbatches, tcfg=tcfg)
        result["trace_s"] = time.perf_counter() - t0
        rl = Roofline(flops_dev=count["flops"],
                      hbm_bytes_dev=count["bytes"],
                      coll_bytes_dev=count["collective_bytes"],
                      n_chips=1, model_flops_global=mf, dtype=cfg.dtype)
        result["memory"] = {
            "per_device_hbm_bytes": count["peak_bytes"],
            "resident_bytes": count["resident_bytes"],
            "fits_hbm": count["peak_bytes"] <= CARD_HBM_BYTES}
        result["counts"] = count
        roofline = rl.to_dict()
    else:
        place = _placement(api, shape, mesh, param_sharding)
        result["trace_s"] = None
        result["place_s"] = time.perf_counter() - t0
        total = sum(place.values())
        result["memory"] = {"per_device_hbm_bytes": total,
                            "placement": place,
                            "fits_hbm": total <= CARD_HBM_BYTES}
        roofline = {k: None for k in (
            "flops_dev", "hbm_bytes_dev", "coll_bytes_dev", "compute_s",
            "memory_s", "collective_s", "dominant", "useful_flops_ratio",
            "roofline_fraction")}
        roofline.update(n_chips=n_chips, model_flops_global=mf,
                        dtype=cfg.dtype)
    result["roofline"] = dict(roofline, memory_floor_s=floor / HBM_BW,
                              params_bytes=params_bytes,
                              cache_bytes=cache_bytes)
    return result


def brief(result: dict) -> dict:
    """The one-line summary of a cell."""
    out = {k: result.get(k) for k in ("arch", "shape", "mesh", "skipped",
                                      "error")}
    if "roofline" in result:
        r, mem = result["roofline"], result["memory"]
        out.update(
            flops=r["flops_dev"], bytes=r["hbm_bytes_dev"],
            peak_gb=mem["per_device_hbm_bytes"] / 1e9,
            fits_80gb=mem["fits_hbm"], dominant=r["dominant"],
            roofline_fraction=r["roofline_fraction"],
            trace_s=result["trace_s"])
    return {k: v for k, v in out.items() if v is not None or k in (
        "flops", "bytes", "dominant", "roofline_fraction", "trace_s")}


# ---------------------------------------------------------------------------

def _cell_path(report_dir, arch, shape_name, mesh_kind) -> pathlib.Path:
    return pathlib.Path(report_dir) / f"{arch}__{shape_name}__{mesh_kind}.json"


def run_and_save(arch, shape_name, mesh_kind, report_dir,
                 microbatches=8) -> dict:
    """run_cell, its record (or its error) written to the report
    directory; returns the record."""
    try:
        result = run_cell(arch, shape_name, mesh_kind,
                          microbatches=microbatches)
    except Exception:  # the sweep goes on; the cell records its error
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "error": traceback.format_exc()}
    out = _cell_path(report_dir, arch, shape_name, mesh_kind)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2))
    return result


def sweep(jobs: int, meshes: tuple[str, ...], force: bool = False, *,
          report_dir=REPORT_DIR, microbatches: int = 8) -> list[tuple]:
    """Every (arch, shape, mesh) cell not yet on disk (all with
    ``force``), in ``jobs`` worker processes; one line a cell as it ends.
    Returns the cells that failed."""
    cells = [(a, s, m) for a in ALL_ARCHS for s in SHAPES for m in meshes]
    pending = [c for c in cells
               if force or not _cell_path(report_dir, *c).exists()]
    # the counted steps first, the longest kind first; placements last
    order = {"train": 0, "prefill": 1, "decode": 2}
    pending.sort(key=lambda c: (c[2] != "card", order[SHAPES[c[1]].kind]))
    print(f"[dryrun] {len(pending)}/{len(cells)} cells to run, jobs={jobs}",
          flush=True)
    failures = []
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
        futures = {pool.submit(run_and_save, *c, str(report_dir),
                               microbatches): c for c in pending}
        for fut in as_completed(futures):
            result = fut.result()
            if "error" in result:
                failures.append(futures[fut])
            line = brief(result)
            if "error" in line:
                line["error"] = line["error"].strip().splitlines()[-1]
            print(json.dumps(line), flush=True)
    print(f"[dryrun] done; {len(failures)} failures: {failures}", flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", default="card",
                    help="card, single or multi; with --all a comma list")
    ap.add_argument("--all", action="store_true", help="sweep every cell")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--report-dir", default=str(REPORT_DIR))
    ap.add_argument(
        "--param-sharding", choices=("auto", "tp"), default="auto",
        help="auto=FSDP+TP (train default); tp=TP-only (serving layout)")
    args = ap.parse_args(argv)
    meshes = tuple(args.mesh.split(","))
    for m in meshes:
        if m not in MESH_KINDS:
            ap.error(f"--mesh: {m!r} is not one of {MESH_KINDS}")

    if args.all:
        failures = sweep(args.jobs, meshes, force=args.force,
                         report_dir=args.report_dir,
                         microbatches=args.microbatches)
        return 1 if failures else 0

    if not (args.arch and args.shape) or len(meshes) != 1:
        ap.error("--arch, --shape and one --mesh (or --all)")
    try:
        result = run_cell(args.arch, args.shape, meshes[0],
                          microbatches=args.microbatches,
                          param_sharding=args.param_sharding)
    except Exception:
        result = {"arch": args.arch, "shape": args.shape, "mesh": meshes[0],
                  "error": traceback.format_exc()}
    out = _cell_path(args.report_dir, args.arch, args.shape, meshes[0])
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2))
    if "error" in result:
        print(json.dumps({"error": result["error"][-2000:]}, indent=2))
        return 1
    print(json.dumps(brief(result), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
