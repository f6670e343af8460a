"""Public op: one GC per drive (group, victim, decision and, when asked,
the drain), dispatched on the tensors' device.

CUDA tensors go to the hand-written kernel, CPU tensors to its plain
version; there is no fallback from one to the other.
"""

from __future__ import annotations

from .kernel import check_args, gc_one_cuda
from .ref import gc_one_ref


def gc_one_(state, gc_w, g, out, enable=None, fault_policy=None,
            fdp_policy=None, **mode):
    """In place: one GC per drive that ``enable`` [D] enables (None:
    every drive), choosing the group by ``mode`` ("gc": the group
    ``g[d]``; "valve"; "movement"), the victim by the weights ``gc_w[d]``,
    and deciding it; with ``drain`` the victim is drained too (under the
    FDP and bloom detectors with §5.6 demotion, which reads the FDP rates
    ``fdp_policy`` under FDP), and with ``fault_policy`` (per-drive rates,
    endurance limit and seed) its erase may fail and retire the block.
    ``out[d] = (victim, g, do)``; a drive left out keeps its state and gets
    ``(-1, -1, 0)``. See
    ``kernels/csrc/gc_one.cu`` for the contract and ``kernel.check_args``
    for the arguments; ``mode`` is mode, td_mode, drain, gc_reserve_blocks
    and erase_max_retries."""
    args = (state, gc_w, g, out, enable, fault_policy, fdp_policy)
    if out.is_cuda:
        gc_one_cuda(*args, **mode)  # checks its args
    elif out.device.type == "cpu":
        check_args(*args, **mode)
        gc_one_ref(*args, **mode)
    else:
        raise ValueError(f"gc_one: no kernel for {out.device}")


__all__ = ["gc_one_", "gc_one_ref"]
