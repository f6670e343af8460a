"""Training launcher: ``--arch <id>`` end to end through the fault-tolerant
runner (the counterpart of ``repro.launch.train``, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --smoke --steps 200 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

``--smoke`` takes the arch's reduced config; without it the full config
trains at full width in its dtype. Batches are the token stream's, as in
the JAX launcher (no stub-frontend inputs).

``--mesh none`` (the default) trains on one device. ``single`` and
``multi`` resolve the production mesh (256 or 512 devices) and the
state's placement on it (``sharding.auto.auto_shardings``); like
``jax.make_mesh`` on a host with fewer devices, they then raise a
ValueError naming the devices the mesh needs and the cards the host has.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.core.fleet import resolve_devices
from repro_torch.data.pipeline import DataConfig, TokenStream, to_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import (
    ALL_ARCHS,
    get_config,
    get_model,
    smoke_config,
)
from repro_torch.sharding.auto import auto_shardings
from repro_torch.train.fault_tolerance import RunnerConfig, TrainRunner
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_loop import (
    TrainConfig,
    init_state,
    make_train_step,
    train_state_specs,
)


def bind_mesh(api, mesh_kind: str, device) -> dict:
    """The production mesh for ``mesh_kind`` and the train state's
    placement on it; raises ValueError when the host has fewer devices
    than the mesh needs. Returns the placement {name: NamedSharding}."""
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    shardings = auto_shardings(train_state_specs(api), mesh)
    have = len(resolve_devices("auto", device))
    if mesh.size > have:
        raise ValueError(
            f"--mesh {mesh_kind}: the mesh {mesh.shape} needs {mesh.size} "
            f"devices; this host has {have} {torch.device(device).type} "
            "device(s)")
    return shardings


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", choices=("none", "single", "multi"),
                    default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    api = get_model(cfg)
    tcfg = TrainConfig(
        opt=OptimizerConfig(lr=args.lr, warmup_steps=10,
                            total_steps=args.steps),
        n_microbatches=args.microbatches,
    )
    stream = TokenStream(DataConfig(cfg.vocab, args.seq, args.batch))
    if args.mesh != "none":
        bind_mesh(api, args.mesh, args.device)
    state = init_state(api, torch.Generator(device=args.device).manual_seed(0))
    step_fn = make_train_step(api, tcfg)
    logged = {"last": time.perf_counter()}

    def step_with_log(state, batch):
        state, metrics = step_fn(state, batch)
        n = int(state["step"])
        if n % args.log_every == 0:
            dt = time.perf_counter() - logged["last"]
            logged["last"] = time.perf_counter()
            print(
                f"step {n:5d}  loss {float(metrics['loss']):.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"lr {float(metrics['lr']):.2e}  ({dt:.2f}s/{args.log_every})"
            )
        return state, metrics

    runner = TrainRunner(
        step_with_log,
        state,
        lambda step: to_device(stream.batch(step), args.device),
        RunnerConfig(
            total_steps=args.steps,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
        ),
    )
    out = runner.run()
    print(
        f"done: step {out['final_step']}  "
        f"loss {float(out['metrics']['loss']):.4f}  "
        f"stragglers {out['stragglers']}  recoveries {out['recoveries']}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
