"""Serving launcher: batched requests over the Wolf-KV paged cache (the
counterpart of ``repro.launch.serve``, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 12 --max-new 24
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch whisper-large-v3 --requests 3 --max-new 4

The model is the arch's smoke config (random weights), as in the JAX
package's launcher; ``--arch`` takes all ten archs, each served as the
JAX package's engine serves it: a transformer over its config.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.models.registry import ALL_ARCHS, get_config, smoke_config
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ALL_ARCHS, default="internlm2-1.8b")
    ap.add_argument("--requests", type=int, default=9)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--static", action="store_true", help="disable Wolf adaptivity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(get_config(args.arch))
    eng = ServingEngine(
        cfg,
        n_blocks=args.blocks,
        page=args.page,
        max_pages_per_seq=64,
        max_batch=8,
        adaptive=not args.static,
        seed=args.seed,
        device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    policies = ["append", "h2o:50", "window:32"]
    for rid in range(args.requests):
        eng.submit(
            Request(
                rid=rid,
                prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
                max_new=args.max_new,
                policy=policies[rid % len(policies)],
            )
        )
    while eng.running or eng.queue:
        info = eng.step()
        if eng.steps % 8 == 0:
            print(
                f"step {eng.steps:4d}  running {info['running']}  "
                f"WA {info['wa']:.3f}  free blocks {info.get('free_blocks', '-')}"
            )
    m = eng.manager
    print(
        f"drained: steps={eng.steps} appended={m.appended} copied={m.copied} "
        f"WA={m.write_amplification:.3f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
