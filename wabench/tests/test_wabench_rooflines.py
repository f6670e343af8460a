"""Each roofline byte count equals the distinct bytes the program's plain
path changes for what it counts: a run of fast writes (``write_run``'s
plain version) and one drained GC (``gc_one``'s plain version)."""

import numpy as np
import torch

from repro_torch.core import managers, simulator, workloads
from repro_torch.core.ssd import Geometry
from repro_torch.kernels.gc_one.ref import gc_one_ref
from repro_torch.kernels.write_run.ref import write_run_ref
from wabench import cell as cells

GEOM = Geometry(8, 64, 16)


def aged_drive(writes=3000):
    """A wolf drive after ``writes`` two-modal writes (open blocks, partly
    dead closed blocks), and its run's policy."""
    mcfg = managers.wolf()
    phase = workloads.two_modal(GEOM.lba_pages, writes)
    st, n_groups, assumed_p, fdp_rate, rates, _ = managers.build_drive(
        GEOM, mcfg, [phase], device="cpu")
    ctx = simulator.SimContext(GEOM, mcfg, n_groups)
    lbas = phase.sample(np.random.default_rng(3))
    st, _ = simulator.run(ctx, st, lbas, page_rate=rates[0],
                          assumed_p=assumed_p, fdp_rate=fdp_rate,
                          device="cpu")
    return st.batch, ctx


def changed_bytes(before, after):
    return int((before != after).sum()) * before.element_size()


def test_write_run_count_is_the_bytes_a_run_changes():
    need = cells.reader("write_run_roofline").__globals__["need"]
    st, ctx = aged_drive()
    state = dict(st.drive_axis)
    # pages of the hot group, distinct; h far off, so only a full active
    # block or a heavy predicate ends the run
    pm = state["page_map"][0].numpy()
    grp = state["group_of"][0].numpy()[np.maximum(pm, 0) // GEOM.pages_per_block]
    hot = np.flatnonzero((pm >= 0) & (grp == 1))
    pages = np.random.default_rng(5).choice(hot, 40, replace=False)
    lbas = torch.as_tensor(pages, dtype=torch.int64)[None]
    n = lbas.shape[1]
    app = torch.full((1, n), -1, dtype=torch.int32)
    mig = torch.full((1, n), -1, dtype=torch.int32)
    start = torch.tensor([[0, int(st.n_app[0])]])
    stop = torch.empty((1, 3), dtype=torch.int64)
    policy = {"page_rate": torch.zeros((1, GEOM.lba_pages)),
              "fdp_rate": torch.zeros((1, 8))}
    keys = ("page_map", "slot_lba", "valid")
    before = {k: state[k].clone() for k in keys}
    write_run_ref(lbas, None, start, stop, state, policy, app, mig,
                  h=10**9, trace_every=1, td_mode="static",
                  movement_ops=True, bloom_rotate_min_writes=64)
    landed = int(stop[0, 0])
    assert landed >= 4
    changed = sum(changed_bytes(before[k], state[k]) for k in keys)
    unset = torch.full((landed,), -1, dtype=torch.int32)
    changed += changed_bytes(unset, app[0, :landed])
    changed += changed_bytes(unset, mig[0, :landed])
    assert need(landed, 0, False)[1] == changed
    assert need(landed, 0, False)[0] == landed * 8


def test_gc_one_count_is_the_bytes_a_gc_changes():
    need = cells.reader("gc_one_roofline").__globals__["need"]
    st, ctx = aged_drive()
    state = dict(st.drive_axis)
    keys = ("page_map", "slot_lba", "valid")
    before = {k: state[k].clone() for k in keys}
    b = GEOM.pages_per_block
    out = torch.empty((1, 3), dtype=torch.int64)
    gc_w = torch.tensor([managers.wolf().gc_weights()])
    gc_one_ref(state, gc_w, None, out, mode="valve", td_mode="static",
               drain=True, gc_reserve_blocks=2)
    victim, _, do = out[0].tolist()
    assert do == 1
    n_live = int(before["valid"][0, victim].sum())
    assert 0 < n_live < b
    changed = sum(changed_bytes(before[k], state[k]) for k in keys)
    # the erase's reset of the victim's page numbers is left out
    erase = changed_bytes(before["slot_lba"][0, victim],
                          state["slot_lba"][0, victim])
    assert need(1, n_live, b)[1] == changed - erase
    assert need(1, n_live, b)[0] == b + 4 * n_live


def test_counts_fix_on_the_work():
    rec = {"op_stream": False, "hbm_bytes_per_s": 3.35e12,
           "pages_per_block": 128,
           "traced": {"summary": {"kernel_s": {
               "void write_run_kernel<0>": 1.0, "void gc_one_kernel<0>": 1.0,
               "other": 5.0}},
               "work": {"n_app": 1000, "n_trim": 0, "n_mig": 500,
                        "n_erase": 10},
               "counts": {"heavy_writes": 100}}}
    wr = cells.reader("write_run_roofline")(rec)
    gc = cells.reader("gc_one_roofline")(rec)
    assert np.isclose(wr, 100 * 900 * 26 / 3.35e12)
    assert np.isclose(gc, 100 * (10 * 128 + 500 * 14) / 3.35e12)
    assert cells.reader("gc_one_roofline")(
        dict(rec, op_stream=True)) is None
