"""The KV-pool compaction's host plan (``kernels/gc_compact/kernel.
plan_moves``) on the CPU.

The CUDA kernel copies a move list in one launch when no row's source is
another row's destination, and otherwise stages only those hazard rows'
sources first. The plan drops no-op rows, checks bounds, refuses two rows
with one destination, and puts the hazard rows first. A plain copy that
follows the plan (stage the hazard rows, then copy row by row, in any
order) must equal ``gc_compact_ref``, whose every read comes before any
write.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.gc_compact import kernel as gc_kernel
from repro_torch.kernels.gc_compact import ops as gc_ops
from repro_torch.kernels.gc_compact import ref as gc_ref

N, P = 12, 8  # blocks, slots a block


def _moves(rng, m, overlap, noop=0.2):
    """A move list of m rows with distinct destinations: sources drawn
    among the destinations' slots too when ``overlap``, from the other
    slots otherwise; a ``noop`` share of rows with src_block -1."""
    slots = rng.permutation(N * P)
    dst = slots[:m]
    pool = slots if overlap else slots[m:]
    src = rng.choice(pool, m, replace=False)
    mv = np.stack([src // P, src % P, dst // P, dst % P], 1)
    mv[rng.random(m) < noop, 0] = -1
    return torch.from_numpy(mv.astype(np.int32))


def _staged_copy(k_pools, v_pools, rows, n_hazard, order):
    """The kernel's plan in plain PyTorch: the hazard rows' sources staged
    first, then each row copied on its own, in ``order``, from the stage
    (hazard rows) or from the pool."""
    for pools in (k_pools, v_pools):
        staged = [pools[:, r[0], r[1]].clone() for r in rows[:n_hazard]]
        for i in order:
            sb, ss, db, ds = rows[i]
            pools[:, db, ds] = staged[i] if i < n_hazard else pools[:, sb, ss]


@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlapping", "disjoint"])
@pytest.mark.parametrize("seed", range(3))
def test_plan_marks_hazard_rows(seed, overlap):
    rng = np.random.default_rng(seed)
    moves = _moves(rng, 40, overlap)
    rows, n_hazard = gc_kernel.plan_moves(moves, N, P)
    mv = moves.numpy()
    live = mv[mv[:, 0] >= 0]
    assert sorted(map(tuple, rows.tolist())) == sorted(
        map(tuple, live.tolist()))
    dst = {(b, s) for b, s in live[:, 2:].tolist()}
    hazard = [(b, s) in dst for b, s in rows[:, :2].tolist()]
    assert hazard == [True] * n_hazard + [False] * (len(rows) - n_hazard)
    assert (n_hazard > 0) == overlap


@pytest.mark.parametrize("order", ["forward", "reverse"])
@pytest.mark.parametrize("overlap", [True, False],
                         ids=["overlapping", "disjoint"])
@pytest.mark.parametrize("seed", range(3))
def test_staged_copy_following_the_plan_equals_ref(seed, overlap, order):
    rng = np.random.default_rng(10 + seed)
    moves = _moves(rng, 48, overlap)
    pools = [torch.from_numpy(rng.normal(size=(2, N, P, 2, 16)).astype(
        np.float32)) for _ in range(2)]
    want = [t.clone() for t in pools]
    gc_ref.gc_compact_ref(*want, moves)
    rows, n_hazard = gc_kernel.plan_moves(moves, N, P)
    idx = range(len(rows))
    got = [t.clone() for t in pools]
    _staged_copy(*got, rows.tolist(), n_hazard,
                 list(idx) if order == "forward" else list(reversed(idx)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not all(torch.equal(g, t) for g, t in zip(got, pools))


def test_plan_refuses_two_rows_with_one_destination():
    moves = torch.tensor([[0, 1, 3, 4], [2, 2, 3, 4], [1, 0, 5, 5]],
                         dtype=torch.int32)
    with pytest.raises(ValueError, match="two moves land on one slot"):
        gc_kernel.plan_moves(moves, N, P)
    pools = [torch.zeros((1, N, P, 2, 16)) for _ in range(2)]
    with pytest.raises(ValueError, match="two moves land on one slot"):
        gc_ops.gc_compact_(*pools, moves)
    # a no-op row's destination is no destination
    moves[1, 0] = -1
    rows, n_hazard = gc_kernel.plan_moves(moves, N, P)
    assert rows.tolist() == [[0, 1, 3, 4], [1, 0, 5, 5]] and n_hazard == 0


def test_plan_of_a_self_move_and_a_chain():
    """A row onto its own slot, and a chain (a → b, b → c): the rows that
    read a destination are the hazard rows, staged first."""
    moves = torch.tensor([[1, 1, 1, 1], [0, 0, 0, 1], [0, 1, 0, 2]],
                         dtype=torch.int32)
    rows, n_hazard = gc_kernel.plan_moves(moves, N, P)
    assert n_hazard == 2
    assert rows.tolist() == [[1, 1, 1, 1], [0, 1, 0, 2], [0, 0, 0, 1]]


def test_plan_of_an_empty_or_all_noop_list():
    for moves in (torch.zeros((0, 4), dtype=torch.int32),
                  torch.tensor([[-1, 99, 99, 99]], dtype=torch.int32)):
        rows, n_hazard = gc_kernel.plan_moves(moves, N, P)
        assert rows.shape == (0, 4) and n_hazard == 0
