"""rounds_per_kstep: the run loop's rounds (one write_run launch and one read
of the D stops each), per 1,000 events of each drive's stream (the fleet's
lock-step position), over the window. From the program's own counter."""


def read(rec):
    return rec["counts"]["rounds"] / rec["ksteps"]
