"""Public op: a run of the simulator's fast-path events, dispatched on the
tensors' device.

CUDA tensors go to the hand-written kernel, CPU tensors to its plain
version; there is no fallback from one to the other.
"""

from __future__ import annotations

from .kernel import check_args, write_run_cuda
from .ref import write_run_ref


def write_run_(lbas, ops, start, stop, state, policy, app, mig, **mode):
    """In place: land each drive's run of fast-path events from
    ``start[d] = (j0, w)`` and write ``stop[d] = (first event not
    completed, w there, why)``, why an index into ``kernel.STOP_WHY``
    (see ``kernels/csrc/write_run.cu`` for the contract and
    ``kernel.check_args`` for the arguments; ``mode`` is h, trace_every,
    td_mode, movement_ops and bloom_rotate_min_writes)."""
    args = (lbas, ops, start, stop, state, policy, app, mig)
    if lbas.is_cuda:
        write_run_cuda(*args, **mode)  # checks its args
    elif lbas.device.type == "cpu":
        check_args(*args, **mode)
        write_run_ref(*args, **mode)
    else:
        raise ValueError(f"write_run: no kernel for {lbas.device}")


__all__ = ["write_run_", "write_run_ref"]
