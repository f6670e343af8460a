"""Train a small LM for a few hundred steps with the whole stack: AdamW,
microbatching, checkpoints and the fault-tolerant runner (the counterpart
of ``examples/train_lm.py``, plus ``--device`` and ``--checkpoint-dir``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    args = ap.parse_args(argv)
    return train_main([
        "--arch", args.arch, "--smoke",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "64", "--microbatches", "2",
        "--checkpoint-every", "100",
        "--checkpoint-dir", args.checkpoint_dir,
        "--device", args.device,
    ])


if __name__ == "__main__":
    raise SystemExit(main())
