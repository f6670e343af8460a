"""sync_wait_pct: the self time of the decisions' reads of the device
(``host.sync``: the wait for the queue to drain and the copy), as a share
of the traced experiment's wall time (its ``fleet.simulate`` span). From
the program's spans (``repro_torch.utils.spans``); the six shares sum to
100."""

from wabench import layers


def read(rec):
    return layers.share("device reads")
