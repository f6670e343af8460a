"""Serve a small model with batched requests over the Wolf-KV paged cache,
the paper's block manager as a serving feature (the counterpart of
``examples/serve_wolf_kv.py``; the flags are ``repro_torch.launch.serve``'s,
``--device`` included).

    PYTHONPATH=src python -m repro_torch.examples.serve_wolf_kv --requests 9
"""

from __future__ import annotations

from repro_torch.launch.serve import main

if __name__ == "__main__":
    raise SystemExit(main())
