"""write_run_roofline: the run kernel's share of its roofline over the
traced experiment: the bytes its work needs at the card's HBM rate, over
its kernel time in the profiler's trace.

The work is fixed by the events, not by the kernel: every event the run
kernel lands (a fast WRITE or a TRIM; the heavy writes go through the
heavy path) reads its page number (4 bytes, and its op code, 1 byte, in an
op stream) and the page's map entry (4), and writes its two trace entries,
the cumulative application writes and migrations (8). A WRITE also writes
the map entry (4) and its new slot's page number and valid byte (5), and,
where every page is mapped (no TRIM in the stream), clears its old slot's
valid byte (1). What not every event needs (the old valid byte where a
TRIM may have unmapped the page, the map entry a TRIM of an unmapped page
leaves as it is) and the block, group and drive counters that the events
of a run share are left out: the count is a lower bound on the bytes a
run needs, so the share is never overstated by them."""

KERNEL = "write_run_kernel"


def need(writes: int, trims: int, op_stream: bool) -> tuple[int, int]:
    """(bytes read, bytes written) by the events a run kernel landed."""
    events = writes + trims
    read = events * (4 + (1 if op_stream else 0) + 4)
    written = events * 8 + writes * (4 + 5 + (0 if op_stream else 1))
    return read, written


def read(rec):
    t = rec["traced"]
    if not t or not t["summary"]:
        return None
    secs = sum(s for n, s in t["summary"]["kernel_s"].items() if KERNEL in n)
    writes = t["work"]["n_app"] - t["counts"]["heavy_writes"]
    trims = t["work"]["n_trim"]
    if secs <= 0 or writes + trims <= 0:
        return None
    total = sum(need(writes, trims, rec["op_stream"]))
    return 100.0 * total / rec["hbm_bytes_per_s"] / secs
