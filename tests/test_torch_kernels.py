"""The port's kernel modules against the JAX package's.

On the CPU the port's ops run their plain PyTorch versions; those are held
here, exactly (integer pools), against the JAX package's 2-D oracles
(``*_ref``), its flat lowerings and its Pallas kernels in interpret mode,
as tests/test_kernels.py runs them. The hand-written CUDA kernels run only
on a card: tests/test_torch_cuda.py holds them against the plain versions
there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gc_compact import kernel as ref_gc_kernel
from repro.kernels.gc_compact import ref as ref_gc
from repro.kernels.write_path import kernel as ref_wp_kernel
from repro.kernels.write_path import ref as ref_wp
from repro_torch.kernels import _build
from repro_torch.kernels.gc_compact import kernel as gc_kernel
from repro_torch.kernels.gc_compact import ops as gc_ops
from repro_torch.kernels.write_path import kernel as wp_kernel
from repro_torch.kernels.write_path import ops as wp_ops

K, B, LBA = 24, 8, 128


def _np(*xs):
    return [np.asarray(x) for x in xs]


def _write_case(seed, *, unmapped=False):
    rng = np.random.default_rng(seed)
    slot_lba = rng.integers(-1, LBA, (K, B)).astype(np.int32)
    valid = rng.random((K, B)) < 0.5
    page_map = rng.integers(-1, K * B, LBA).astype(np.int32)
    lba = int(rng.integers(0, LBA))
    if unmapped:
        page_map[lba] = -1
    old_pm = int(page_map[lba])
    dst_blk, dst_slot = int(rng.integers(0, K)), int(rng.integers(0, B))
    while dst_blk * B + dst_slot == old_pm:  # never the page's own slot
        dst_slot = (dst_slot + 1) % B
    return page_map, slot_lba, valid, (lba, old_pm, dst_blk, dst_slot)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("unmapped", [False, True], ids=["mapped", "old_pm=-1"])
def test_apply_write_matches_reference(seed, unmapped):
    page_map, slot_lba, valid, scalars = _write_case(seed, unmapped=unmapped)
    j = (jnp.asarray(page_map), jnp.asarray(slot_lba), jnp.asarray(valid),
         *map(jnp.asarray, scalars))
    want = _np(*ref_wp.apply_write_ref(*j))
    for other in (ref_wp.apply_write_flat(*j),
                  ref_wp_kernel.apply_write(*j, interpret=True)):
        for a, b in zip(_np(*other), want):
            np.testing.assert_array_equal(a, b)
    t = (torch.from_numpy(page_map), torch.from_numpy(slot_lba),
         torch.from_numpy(valid))
    for fn in (wp_ops.apply_write_ref, wp_ops.apply_write):
        got = fn(*t, *scalars)
        for g, w, inp in zip(got, want, t):
            assert g.dtype == inp.dtype
            np.testing.assert_array_equal(g.numpy(), w)
    # functional: the inputs are untouched
    np.testing.assert_array_equal(t[0].numpy(), page_map)


def test_apply_write_disabled_row_is_noop():
    """ok = 0 leaves every pool untouched, as the Pallas kernel with
    enabled=False does."""
    page_map, slot_lba, valid, (lba, old_pm, blk, slot) = _write_case(11)
    ref_out = ref_wp_kernel.apply_write(
        jnp.asarray(page_map), jnp.asarray(slot_lba), jnp.asarray(valid),
        jnp.asarray(lba), jnp.asarray(old_pm), jnp.asarray(blk),
        jnp.asarray(slot), enabled=jnp.asarray(False), interpret=True,
    )
    pools = [torch.from_numpy(x.copy())[None]
             for x in (page_map, slot_lba, valid)]
    row = torch.tensor([[lba, old_pm, blk * B + slot, 0]], dtype=torch.int32)
    wp_ops.apply_write_(row, *pools)
    for got, want in zip(pools, _np(*ref_out)):
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_apply_write_batched_rows_match_per_drive_reference():
    """D drives in one call == each drive through the 2-D oracle; rows with
    ok = 0, old_pm = -1 and out-of-range indices are skipped."""
    d = 6
    cases = [_write_case(100 + i, unmapped=i == 1) for i in range(d)]
    rows = []
    for i, (_, _, _, (lba, old, blk, slot)) in enumerate(cases):
        ok = 0 if i == 2 else 1
        new = K * B + 3 if i == 3 else blk * B + slot  # out of range: skip
        rows.append([lba, old, new, ok])
    pools = [torch.from_numpy(np.stack([c[j] for c in cases]))
             for j in range(3)]
    wp_ops.apply_write_(torch.tensor(rows, dtype=torch.int32), *pools)
    for i, (pm, sl, va, (lba, old, blk, slot)) in enumerate(cases):
        if i in (2, 3):
            want = (pm.copy(), sl, va.copy())
            if i == 3 and old >= 0:  # the clear still lands
                want[2][old // B, old % B] = False
        else:
            want = _np(*ref_wp.apply_write_ref(
                jnp.asarray(pm), jnp.asarray(sl), jnp.asarray(va),
                *map(jnp.asarray, (lba, old, blk, slot))))
        for got, w in zip(pools, want):
            np.testing.assert_array_equal(got[i].numpy(), w)


def _compact_case(seed, *, interleave=False):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, B + 1))
    slot_lba = rng.integers(-1, 200, (K, B)).astype(np.int32)
    valid = rng.random((K, B)) < 0.5
    if interleave:  # sources and destinations share slots of two blocks
        base = int(rng.integers(0, K - 1)) * B
        src = base + rng.permutation(2 * B)[:m]
        dst = base + rng.permutation(2 * B)[:m]
        sb, ss = (src // B).astype(np.int32), (src % B).astype(np.int32)
    else:  # GC-shaped: one victim block's slots to distinct other slots
        victim = int(rng.integers(0, K))
        dst = rng.choice((K - 1) * B, m, replace=False)
        dst = np.where(dst // B >= victim, dst + B, dst)
        sb = np.full(m, victim, np.int32)
        ss = rng.choice(B, m, replace=False).astype(np.int32)
    db, ds = (dst // B).astype(np.int32), (dst % B).astype(np.int32)
    sb = np.where(rng.random(m) < 0.3, -1, sb).astype(np.int32)  # no-ops
    return slot_lba, valid, (sb, ss, db, ds)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("interleave", [False, True],
                         ids=["gc_shaped", "interleaved"])
def test_compact_slots_matches_reference(seed, interleave):
    slot_lba, valid, moves = _compact_case(seed, interleave=interleave)
    jmoves = [jnp.asarray(x) for x in moves]
    want = _np(*ref_gc.compact_slots_ref(
        jnp.asarray(slot_lba), jnp.asarray(valid), *jmoves))
    for other in (
        ref_gc.compact_slots_dense(jnp.asarray(slot_lba),
                                   jnp.asarray(valid), *jmoves),
        ref_gc_kernel.compact_slots(jnp.asarray(slot_lba),
                                    jnp.asarray(valid), *jmoves,
                                    interpret=True),
    ):
        for a, b in zip(_np(*other), want):
            np.testing.assert_array_equal(a, b)
    t = (torch.from_numpy(slot_lba), torch.from_numpy(valid))
    tmoves = [torch.from_numpy(x) for x in moves]
    for fn in (gc_ops.compact_slots_ref, gc_ops.compact_slots):
        got = fn(*t, *tmoves)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(t[0].numpy(), slot_lba)  # functional


def test_compact_slots_batched_matches_per_drive_reference():
    d = 5
    cases = [_compact_case(200 + i, interleave=i % 2 == 1) for i in range(d)]
    m = max(len(c[2][0]) for c in cases)

    def pad(x):  # pad every move list to m rows with no-op rows
        return np.concatenate([x, np.full(m - len(x), -1, np.int32)])

    pools = [torch.from_numpy(np.stack([c[j] for c in cases]))
             for j in range(2)]
    moves = [torch.from_numpy(np.stack([pad(c[2][j]) for c in cases]))
             for j in range(4)]
    gc_ops.compact_slots_(*pools, *moves)
    for i, (sl, va, mv) in enumerate(cases):
        want = _np(*ref_gc.compact_slots_ref(
            jnp.asarray(sl), jnp.asarray(va), *map(jnp.asarray, mv)))
        for got, w in zip(pools, want):
            np.testing.assert_array_equal(got[i].numpy(), w)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "no_drive_axis"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    rows = torch.zeros((1, 4), dtype=torch.int32)
    pools = [torch.zeros((1, LBA), dtype=torch.int32),
             torch.zeros((1, K, B), dtype=torch.int32),
             torch.zeros((1, K, B), dtype=torch.bool)]
    moves = [torch.zeros((1, B), dtype=torch.int32) for _ in range(4)]
    if bad == "dtype":
        rows, moves[0] = rows.long(), moves[0].long()
    elif bad == "shape":
        rows, moves[0] = rows[:, :3], moves[0][:, :3]
    elif bad == "contiguity":
        pools[1] = torch.zeros((1, B, K), dtype=torch.int32).transpose(1, 2)
    else:
        pools = [p[0] for p in pools]
    with pytest.raises(ValueError):
        wp_ops.apply_write_(rows, *pools)
    with pytest.raises(ValueError):
        gc_ops.compact_slots_(pools[1], pools[2], *moves)


def test_cpu_dispatch_launches_no_kernel():
    before = (wp_kernel.launches, gc_kernel.launches)
    page_map, slot_lba, valid, scalars = _write_case(0)
    wp_ops.apply_write(torch.from_numpy(page_map), torch.from_numpy(slot_lba),
                       torch.from_numpy(valid), *scalars)
    sl, va, moves = _compact_case(0)
    gc_ops.compact_slots(torch.from_numpy(sl), torch.from_numpy(va),
                         *map(torch.from_numpy, moves))
    assert (wp_kernel.launches, gc_kernel.launches) == before
    with pytest.raises(ValueError, match="tensors on cpu"):
        wp_kernel.apply_write_cuda(
            torch.zeros((1, 4), dtype=torch.int32),
            torch.zeros((1, LBA), dtype=torch.int32),
            torch.zeros((1, K, B), dtype=torch.int32),
            torch.zeros((1, K, B), dtype=torch.bool),
        )


def test_every_kernel_source_has_a_launcher():
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(_build.SIGNATURES)
    for name in sources:
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {_build.SIGNATURES[name][0]}(' in text
        assert _build.library(name).parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
