"""host_syncs_per_kstep: the run loop's device-to-host reads for decisions,
per 1,000 events of each drive's stream (the fleet's lock-step position),
over the window. From the program's own counter."""


def read(rec):
    return rec["counts"]["host_syncs"] / rec["ksteps"]
