"""Carry drive state between the JAX package and this one.

A simulator's weights are its state: ``state_from_numpy`` builds this
package's :class:`~repro_torch.core.ssd.SimState` from the JAX package's
state turned into numpy (``{k: np.asarray(v) for k, v in st.items()}``), so
a run started there continues here; ``state_to_numpy`` goes the other way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ssd import SIM_STATE_DTYPES, SimState


def state_from_numpy(d: dict, device="cuda") -> SimState:
    """A SimState on ``device`` from a dict of numpy arrays, one per field,
    each in its field's dtype (checked, never cast)."""
    missing = set(SIM_STATE_DTYPES) - set(d)
    if missing:
        raise KeyError(f"state fields missing: {sorted(missing)}")
    fields = {}
    for name, dtype in SIM_STATE_DTYPES.items():
        arr = np.ascontiguousarray(d[name])
        t = torch.from_numpy(arr.copy())
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arr.dtype} is not {dtype}")
        fields[name] = t.to(device)
    return SimState(**fields)


def state_to_numpy(st: SimState) -> dict:
    """Every field of ``st`` as a numpy array on the host."""
    return {k: v.cpu().numpy() for k, v in st.items()}
