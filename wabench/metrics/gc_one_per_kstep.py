"""gc_one_per_kstep: the GC kernel's launches (2 a heavy write, and the
valve's), per 1,000 events of each drive's stream (the fleet's lock-step
position), over the window. From the program's own counter."""


def read(rec):
    return rec["counts"]["gc_one_launches"] / rec["ksteps"]
