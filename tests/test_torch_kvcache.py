"""The port's Wolf-KV manager against the JAX package's.

Both managers are driven through the same op sequences, drawn from a seed
with numpy (the cases of tests/test_wolf_kv.py::TestManager and a grid of
seeds). Every value an op returns, every drained move list, and the state
at the end (block tables, slot_valid, counters, per-group stats with
``alloc_blocks`` and ``p_ewma``) must be identical.
"""

import numpy as np
import pytest

from repro.kvcache import manager as ref_manager
from repro_torch.kvcache import manager

BOTH = (ref_manager.WolfKVManager, manager.WolfKVManager)


def snapshot(mgr, max_pages=64) -> dict:
    """Everything the manager decides, in plain Python and numpy."""
    snap = {
        "appended": mgr.appended, "copied": mgr.copied,
        "since_interval": mgr.since_interval, "free": list(mgr.free),
        "block_group": mgr.block_group.tolist(),
        "block_live": mgr.block_live.tolist(),
        "block_seq": mgr.block_seq.tolist(),
        "groups": [(g.size_slots, g.n_blocks, g.appends_interval, g.p_ewma,
                    g.alloc_blocks) for g in mgr.groups],
        "wa": mgr.write_amplification,
    }
    for sid, seq in mgr.seqs.items():
        snap[f"seq{sid}"] = (
            seq.group, seq.cache_len, seq.n_dead,
            mgr.block_table(sid, max_pages).tolist(),
            mgr.slot_valid(sid, max_pages).tolist(),
        )
    return snap


def run_both(script, *args, **kw):
    """Run ``script(mgr, log, rng)`` on a fresh manager of each package;
    return (log, snapshot) for each."""
    out = []
    for cls in BOTH:
        mgr = cls(*args, **kw)
        log = []
        script(mgr, log, np.random.default_rng(0))
        mgr.check_invariants()
        log.append(("moves", mgr.drain_moves()))
        out.append((log, snapshot(mgr)))
    return out


def assert_same(runs):
    (ref_log, ref_snap), (log, snap) = runs
    assert len(log) == len(ref_log)
    for i, (a, b) in enumerate(zip(log, ref_log)):
        assert a == b, f"op {i}: {a} != {b}"
    assert snap == ref_snap


def churn(n_seqs=6, n_ops=3000, max_live=24, seed=0):
    """test_wolf_kv.py::TestManager._churn, logging every decision."""
    def script(mgr, log, _):
        rng = np.random.default_rng(seed)
        for sid in range(n_seqs):
            mgr.add_sequence(sid, sid % mgr.n_groups)
        for _ in range(n_ops):
            sid = int(rng.integers(n_seqs))
            log.append(("append", mgr.append_token(sid)))
            seq = mgr.seqs[sid]
            alive = np.flatnonzero(seq.valid[: seq.cache_len])
            if len(alive) > max_live:
                mgr.evict_token(sid, int(rng.choice(alive[:-2])))
            if mgr.pending_moves:
                log.append(("moves", mgr.drain_moves()))
    return script


def test_basic_lifecycle():
    def script(mgr, log, _):
        mgr.add_sequence(0, 0)
        for _ in range(20):
            log.append(mgr.append_token(0))
        mgr.finish_sequence(0)
    assert_same(run_both(script, 64, 8, 2))


def test_window_eviction():
    def script(mgr, log, _):
        mgr.add_sequence(0, 0)
        for t in range(200):
            log.append(mgr.append_token(0))
            if t >= 32:
                mgr.evict_token(0, t - 32)
    runs = run_both(script, 64, 8, 1)
    assert_same(runs)
    assert runs[1][1]["copied"] == 0


def test_compaction():
    def script(mgr, log, rng):
        mgr.add_sequence(0, 0)
        for _ in range(80):
            log.append(mgr.append_token(0))
        alive = np.flatnonzero(mgr.seqs[0].valid[:80])
        for ci in rng.choice(alive, 40, replace=False):
            mgr.evict_token(0, int(ci))
        log.append(("gc", mgr.gc_group(0)))
    runs = run_both(script, 16, 8, 1, adaptive=False)
    assert_same(runs)
    assert runs[1][1]["copied"] > 0


@pytest.mark.parametrize("budget_blocks", [20, 28, 44])
def test_pinned_budget_churn(budget_blocks):
    """test_more_spare_means_less_wa's runs: one group, budget pinned."""
    def script(mgr, log, _):
        mgr.groups[0].alloc_blocks = budget_blocks
        rng = np.random.default_rng(1)
        mgr.add_sequence(0, 0)
        for _ in range(128):
            mgr.append_token(0)
        for _ in range(1500):
            log.append(mgr.append_token(0))
            seq = mgr.seqs[0]
            alive = np.flatnonzero(seq.valid[: seq.cache_len])
            mgr.evict_token(0, int(rng.choice(alive[:-1])))
            if mgr.pending_moves:
                log.append(("moves", mgr.drain_moves()))
    assert_same(run_both(script, 64, 8, 1, adaptive=False))


@pytest.mark.parametrize("adaptive", [True, False])
def test_churn_swap(adaptive):
    """test_adaptive_beats_static_after_churn_swap's runs (shortened)."""
    def script(mgr, log, _):
        rng = np.random.default_rng(2)
        mgr.add_sequence(0, 0)
        mgr.add_sequence(1, 1)
        for _ in range(96):
            mgr.append_token(0)
            mgr.append_token(1)
        if not adaptive:
            mgr.groups[0].alloc_blocks = 20
            mgr.groups[1].alloc_blocks = 90

        def step(sid, hot):
            log.append(mgr.append_token(sid))
            if hot:
                seq = mgr.seqs[sid]
                alive = np.flatnonzero(seq.valid[: seq.cache_len])
                mgr.evict_token(sid, int(rng.choice(alive[:-1])))

        for _ in range(1200):
            step(1, True)
            if rng.random() < 0.1:
                step(0, False)
        log.append(("moves", mgr.drain_moves()))
        for _ in range(1200):
            step(0, True)
    assert_same(run_both(script, 128, 8, 2, adaptive=adaptive,
                         interval=256))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("n_groups,adaptive", [(1, True), (2, False),
                                               (3, True)])
def test_random_churn_grid(seed, n_groups, adaptive):
    assert_same(run_both(churn(n_ops=1500, seed=seed), 96, 8, n_groups,
                         adaptive=adaptive))


@pytest.mark.parametrize("n_groups", [1, 2, 3, 4])
def test_recompute_alloc_to_the_integer(n_groups):
    """§5.5 allocation from random sizes and frequencies: the port's
    alloc_blocks (a ceil) equal the JAX package's, over many draws."""
    rng = np.random.default_rng(n_groups)
    mgrs = [cls(512, 16, n_groups) for cls in BOTH]
    for _ in range(200):
        sizes = rng.integers(0, 2000, n_groups)
        p = rng.dirichlet(np.ones(n_groups)) * (rng.random() < 0.9)
        for mgr in mgrs:
            for g, st in enumerate(mgr.groups):
                st.size_slots, st.p_ewma = int(sizes[g]), float(p[g])
            mgr._recompute_alloc()
        assert [st.alloc_blocks for st in mgrs[1].groups] == \
            [st.alloc_blocks for st in mgrs[0].groups]
