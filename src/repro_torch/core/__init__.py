"""Core: SSD state, workloads, OP allocation, the simulator and the block
managers (the counterpart of ``repro.core``), with the same public names:
the WA analytics and the allocators."""

from .analytics import (
    block_decay_updates,
    block_live_pages,
    delta_from_op_ratio,
    delta_from_op_ratio_lambertw,
    delta_from_wa,
    lambertw0,
    op_ratio_from_delta,
    op_ratio_from_wa,
    wa_from_delta,
    wa_from_op_ratio,
)
from .allocation import (
    allocate_by_frequency,
    allocate_by_size,
    allocate_closed_form,
    group_delta,
    group_wa,
    hillclimb_allocation,
    optimal_allocation,
    total_wa,
)
