"""Cells of the benchmark cut to a size the CPU tests can hold: the
configuration at Geometry(8, 64, 16) (blocks and pages a block cut, the
ratios kept), a few drives, a few thousand events."""

from wabench import cell as cells

BLOCKS_PER_LUN, PAGES_PER_BLOCK = 64, 16


def small_cell(name: str, drives: int = 4, events: int = 2000) -> dict:
    c = cells.load_cell(name)
    c["config"]["geometry"].update(blocks_per_lun=BLOCKS_PER_LUN,
                                   pages_per_block=PAGES_PER_BLOCK)
    c["traffic"]["drives"] = drives
    c["traffic"]["check_drives"] = min(c["traffic"]["check_drives"], drives)
    for ph in c["traffic"]["phases"]:
        ph["events"] = events
    return c


CELLS = ("wolf_two_modal_d1024", "dyn_tpcc_churn_d8")
