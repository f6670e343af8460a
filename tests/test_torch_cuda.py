"""The port on a CUDA card: the hand-written kernels against their plain
PyTorch versions, and card runs of the simulator against CPU runs.

Every test here needs a card and skips without one. The file imports
nothing of JAX, so it also runs on a GPU host without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Comparisons are exact (integer pools and integer state; ``grp_p`` too,
since card and CPU run the same float32 operations in the same order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import managers, workloads
from repro_torch.core.ssd import Geometry, assert_invariants
from repro_torch.kernels.gc_compact import kernel as gc_kernel
from repro_torch.kernels.gc_compact import ops as gc_ops
from repro_torch.kernels.write_path import kernel as wp_kernel
from repro_torch.kernels.write_path import ops as wp_ops

K, B, LBA = 24, 8, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _write_rows(rng, d):
    """Pools for d drives and one valid op row per drive: old_pm is the
    page's mapping (-1 on drive 0), the new slot differs from it, and every
    fourth row is disabled."""
    page_map = rng.integers(-1, K * B, (d, LBA)).astype(np.int32)
    slot_lba = rng.integers(-1, LBA, (d, K, B)).astype(np.int32)
    valid = rng.random((d, K, B)) < 0.5
    rows = []
    for i in range(d):
        lba = int(rng.integers(0, LBA))
        if i == 0:
            page_map[i, lba] = -1
        old = int(page_map[i, lba])
        new = int(rng.integers(0, K * B))
        new = (new + 1) % (K * B) if new == old else new
        rows.append([lba, old, new, int(i % 4 != 3)])
    return np.asarray(rows, np.int32), page_map, slot_lba, valid


def _moves(rng, d):
    """Move lists of B rows per drive whose sources and destinations are
    slots of the same two blocks (interleaved); about a fifth are no-ops."""
    src, dst = [], []
    for _ in range(d):
        base = int(rng.integers(0, K - 1)) * B
        src.append(base + rng.permutation(2 * B)[:B])
        dst.append(base + rng.permutation(2 * B)[:B])
    src, dst = np.asarray(src), np.asarray(dst)
    sb = np.where(rng.random((d, B)) < 0.2, -1, src // B)
    return [x.astype(np.int32) for x in (sb, src % B, dst // B, dst % B)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 9])
def test_kernels_match_plain_versions(cuda, d):
    rng = np.random.default_rng(d)
    rows, *pools = (torch.from_numpy(x).to(cuda) for x in _write_rows(rng, d))
    got, want = [p.clone() for p in pools], [p.clone() for p in pools]
    n = wp_kernel.launches
    wp_kernel.apply_write_cuda(rows, *got)
    assert wp_kernel.launches == n + 1
    wp_ops.apply_write_flat(rows, *want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    pools = [torch.from_numpy(x).to(cuda) for x in (
        rng.integers(-1, LBA, (d, K, B)).astype(np.int32),
        rng.random((d, K, B)) < 0.5,
    )]
    moves = [torch.from_numpy(x).to(cuda) for x in _moves(rng, d)]
    got, want = [p.clone() for p in pools], [p.clone() for p in pools]
    n = gc_kernel.launches
    gc_kernel.compact_slots_cuda(*got, *moves)
    assert gc_kernel.launches == n + 1
    gc_ops.compact_slots_flat(*want, *moves)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _trim_rows(rng, d):
    """Pools for d drives and one TRIM row per drive: old_pm is the page's
    mapping (-1 on drive 0: a re-trim), every fourth row is disabled."""
    page_map = rng.integers(-1, K * B, (d, LBA)).astype(np.int32)
    valid = rng.random((d, K, B)) < 0.5
    rows = []
    for i in range(d):
        lba = int(rng.integers(0, LBA))
        if i == 0:
            page_map[i, lba] = -1
        rows.append([lba, int(page_map[i, lba]), int(i % 4 != 3)])
    return np.asarray(rows, np.int32), page_map, valid


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 9])
def test_trim_kernel_matches_plain_version(cuda, d):
    rng = np.random.default_rng(10 + d)
    rows, *pools = (torch.from_numpy(x).to(cuda) for x in _trim_rows(rng, d))
    got, want = [p.clone() for p in pools], [p.clone() for p in pools]
    n = (wp_kernel.launches, wp_kernel.trim_launches)
    wp_kernel.apply_trim_cuda(rows, *got)
    assert (wp_kernel.launches, wp_kernel.trim_launches) == (n[0], n[1] + 1)
    wp_ops.apply_trim_flat(rows, *want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_card_op_stream_run_matches_cpu_run(cuda):
    """wolf_dynamic on tpcc_churn (bloom detector, demoting drains, §5.2
    groups, TRIMs) on the card equals the CPU run, bit for bit."""
    geom = Geometry(4, 32, 8)
    phases = [workloads.tpcc_churn(geom.lba_pages, 3000)]
    n = wp_kernel.trim_launches
    card = managers.simulate(geom, managers.wolf_dynamic(), phases, seed=3,
                             device="cuda")
    assert wp_kernel.trim_launches > n
    host = managers.simulate(geom, managers.wolf_dynamic(), phases, seed=3,
                             device="cpu")
    np.testing.assert_array_equal(card.app, host.app)
    np.testing.assert_array_equal(card.mig, host.mig)
    for name, v in card.state.items():
        assert torch.equal(v.cpu(), host.state[name]), name
    assert_invariants(card.state)


@pytest.mark.cuda
def test_card_run_matches_cpu_run(cuda):
    geom = Geometry(4, 32, 8)
    phases = [workloads.two_modal(geom.lba_pages, 3000)]
    n = (wp_kernel.launches, gc_kernel.launches)
    card = managers.simulate(geom, managers.wolf(), phases, seed=3,
                             device="cuda")
    assert wp_kernel.launches > n[0] and gc_kernel.launches > n[1]
    host = managers.simulate(geom, managers.wolf(), phases, seed=3,
                             device="cpu")
    np.testing.assert_array_equal(card.app, host.app)
    np.testing.assert_array_equal(card.mig, host.mig)
    for name, v in card.state.items():
        assert torch.equal(v.cpu(), host.state[name]), name
    assert_invariants(card.state)
