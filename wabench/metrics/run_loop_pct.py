"""run_loop_pct: the run loop's self time (``sim.round``: the ``write_run``
launch, the round's host bookkeeping and the stopped events' trace
entries), as a share of the traced experiment's wall time (its
``fleet.simulate`` span). From the program's spans
(``repro_torch.utils.spans``); the six shares sum to 100."""

from wabench import layers


def read(rec):
    return layers.share("run loop")
