"""Wolf-KV: the paper's block manager driving a paged KV cache.

Mapping: KV blocks = erase blocks, token slots = flash pages, token
eviction (H2O/sliding-window style) = page invalidation, compaction = GC
migration, spare blocks = over-provisioned space, sequence churn classes =
temperature groups. Write-amplification = slots copied by compaction / slots
appended. This is the HOST control plane (numpy); block tables, validity
masks and move lists are consumed on device by kernels/paged_attention and
kernels/gc_compact.

The port keeps the JAX package's manager (repro/kvcache/manager.py) line
for line, so both take the same decisions on the same op sequence
(tests/test_torch_kvcache.py); only ``_recompute_alloc`` calls this
package's ``core.allocation.allocate_closed_form``, on float32 CPU tensors,
whose in-order group sums give the JAX package's allocation to the bit.

Layout invariant (slot congruence): a sequence's cache index ci lives at
slot ci % P of block table[ci // P]; blocks are not shared across sequences
(vLLM convention), so the paged-attention kernel needs only the table + a
per-slot validity mask (eviction holes are masked, not rewritten).

Economics — exactly the paper's:
  * eviction punches holes; a group's spare blocks determine how long its
    sequences defer compaction;
  * compaction (greedy victim = most-dead sequence) rewrites the survivor
    tokens densely into FRESH blocks (the migrate-then-erase of §5.4) and
    frees the old ones — copies/reclaimed-slot falls as spare grows (the
    δ(OP) curve of eq. 3);
  * Wolf measures per-group append frequencies and splits the spare with the
    closed form (eq. 8), moving physical blocks between groups when the
    workload shifts (§5.3 movement operations);
  * the "static" baseline fixes the split once (FDP-like assumptions).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.core.allocation import allocate_closed_form


@dataclasses.dataclass
class KVGroupStats:
    size_slots: int = 0       # live token slots
    n_blocks: int = 0         # physical blocks held
    appends_interval: int = 0
    p_ewma: float = 0.0
    alloc_blocks: int = 1


@dataclasses.dataclass
class _Seq:
    group: int
    cache_len: int = 0                      # dense length incl. holes
    n_dead: int = 0                         # holes below cache_len
    blocks: list = dataclasses.field(default_factory=list)  # logical page → block
    valid: np.ndarray = None                # [cache_len] bool (grown lazily)

    def ensure(self, n):
        if self.valid is None:
            self.valid = np.zeros(max(n, 64), bool)
        elif len(self.valid) < n:
            grown = np.zeros(max(n, 2 * len(self.valid)), bool)
            grown[: len(self.valid)] = self.valid
            self.valid = grown


class WolfKVManager:
    def __init__(
        self,
        n_blocks: int,
        page_size: int,
        n_groups: int,
        *,
        adaptive: bool = True,
        interval: int = 512,
        ewma_a: float = 0.3,
        reserve_blocks: int = 2,
    ):
        self.n_blocks = n_blocks
        self.page = page_size
        self.n_groups = n_groups
        self.adaptive = adaptive
        self.interval = interval
        self.ewma_a = ewma_a
        self.reserve = reserve_blocks

        self.free: deque[int] = deque(range(n_blocks))
        self.block_group = np.full(n_blocks, -1, np.int32)
        self.block_live = np.zeros(n_blocks, np.int32)
        self.block_seq = np.full(n_blocks, -1, np.int64)
        self.groups = [KVGroupStats() for _ in range(n_groups)]
        self.seqs: dict[int, _Seq] = {}

        self.appended = 0
        self.copied = 0
        self.since_interval = 0
        self.pending_moves: list[tuple[int, int, int, int]] = []
        self._recompute_alloc()

    # -- metrics --------------------------------------------------------------
    @property
    def write_amplification(self) -> float:
        return (self.appended + self.copied) / max(self.appended, 1)

    def mark(self) -> tuple[int, int]:
        return (self.appended, self.copied)

    def wa_since(self, mark) -> float:
        da, dc = self.appended - mark[0], self.copied - mark[1]
        return (da + dc) / max(da, 1)

    # -- sequence lifecycle -----------------------------------------------------
    def add_sequence(self, seq_id: int, group: int):
        assert 0 <= group < self.n_groups
        self.seqs[seq_id] = _Seq(group=group)

    def finish_sequence(self, seq_id: int):
        seq = self.seqs.pop(seq_id)
        g = seq.group
        live = int(seq.valid[: seq.cache_len].sum()) if seq.valid is not None else 0
        self.groups[g].size_slots -= live
        for blk in seq.blocks:
            if blk >= 0:
                self._free_block(blk, g)

    # -- data path --------------------------------------------------------------
    def append_token(self, seq_id: int) -> tuple[int, int]:
        """Reserve the next cache slot; returns (block, slot) for the device
        cache write. May trigger GC / movement ops (device moves accumulate
        in self.pending_moves until drain_moves()).

        GC runs BEFORE indices are read: compaction may rewrite this very
        sequence (shrinking cache_len), so ci/blocks must be computed after.
        """
        seq = self.seqs[seq_id]
        g = seq.group
        st = self.groups[g]
        if seq.cache_len % self.page == 0 and (
            st.n_blocks >= st.alloc_blocks or len(self.free) <= self.reserve
        ):
            self.gc_group(g)
            if len(self.free) <= 1:
                best = max(range(self.n_groups), key=self._group_dead_slots)
                self.gc_group(best)
        ci = seq.cache_len
        pg = ci // self.page
        if pg >= len(seq.blocks):
            seq.blocks.append(self._claim_block(g, seq_id))
        blk = seq.blocks[pg]
        slot = ci % self.page
        seq.ensure(ci + 1)
        seq.valid[ci] = True
        seq.cache_len += 1
        self.block_live[blk] += 1
        st = self.groups[g]
        st.size_slots += 1
        st.appends_interval += 1
        self.appended += 1
        self.since_interval += 1
        if self.since_interval >= self.interval:
            self._interval_update()
        return blk, slot

    def evict_token(self, seq_id: int, ci: int):
        """Invalidate cache index ci (H2O-style). Fully-dead pages are freed
        immediately (no copies); interior holes wait for compaction."""
        seq = self.seqs[seq_id]
        assert 0 <= ci < seq.cache_len and seq.valid[ci], (ci, seq.cache_len)
        seq.valid[ci] = False
        seq.n_dead += 1
        pg = ci // self.page
        blk = seq.blocks[pg]
        self.block_live[blk] -= 1
        self.groups[seq.group].size_slots -= 1
        is_tail = pg == (seq.cache_len - 1) // self.page
        if self.block_live[blk] == 0 and not is_tail:
            self._free_block(blk, seq.group)
            seq.blocks[pg] = -1
            # page fully dead: holes in it no longer count as reclaimable
            lo, hi = pg * self.page, min((pg + 1) * self.page, seq.cache_len)
            seq.n_dead -= int((~seq.valid[lo:hi]).sum())

    # -- device views -------------------------------------------------------------
    def block_table(self, seq_id: int, max_pages: int) -> np.ndarray:
        seq = self.seqs[seq_id]
        t = np.full(max_pages, -1, np.int32)
        n = min(len(seq.blocks), max_pages)
        t[:n] = seq.blocks[:n]
        return t

    def slot_valid(self, seq_id: int, max_pages: int) -> np.ndarray:
        seq = self.seqs[seq_id]
        v = np.zeros(max_pages * self.page, bool)
        n = min(seq.cache_len, len(v))
        if seq.valid is not None:
            v[:n] = seq.valid[:n]
        return v.reshape(max_pages, self.page)

    def cache_len(self, seq_id: int) -> int:
        return self.seqs[seq_id].cache_len

    def drain_moves(self) -> list[tuple[int, int, int, int]]:
        moves, self.pending_moves = self.pending_moves, []
        return moves

    # -- block plumbing -----------------------------------------------------------
    def _claim_block(self, g: int, seq_id: int) -> int:
        st = self.groups[g]
        if not self.free:
            # last resort: reclaim from the most-compactable group anywhere
            best = max(range(self.n_groups), key=self._group_dead_slots)
            self.gc_group(best)
        if not self.free:
            raise RuntimeError("KV pool exhausted — undersized cache")
        blk = self.free.popleft()
        self.block_group[blk] = g
        self.block_seq[blk] = seq_id
        st.n_blocks += 1
        return blk

    def _free_block(self, blk: int, g: int):
        self.block_group[blk] = -1
        self.block_seq[blk] = -1
        self.block_live[blk] = 0
        self.groups[g].n_blocks -= 1
        self.free.append(blk)

    def _group_dead_slots(self, g: int) -> int:
        return sum(
            s.n_dead for s in self.seqs.values() if s.group == g
        )

    # -- GC: sequence compaction (§5.4 migrate-then-erase) -------------------------
    def gc_group(self, g: int) -> int:
        """Compact the most-reclaimable sequence in group g. Returns slots
        copied. Survivors are rewritten densely into fresh blocks from the
        first holey page onward; old blocks are erased to the pool."""
        victims = [
            (s.n_dead, sid) for sid, s in self.seqs.items() if s.group == g and s.n_dead
        ]
        if not victims:
            return 0
        _, sid = max(victims)
        return self._compact_sequence(sid)

    def _compact_sequence(self, sid: int) -> int:
        """Rewrite the sequence densely from its first holey page onward.

        Page-wise with progressive reclamation: a source page whose survivors
        have all been scheduled is freed BEFORE the next destination block is
        claimed, so compaction needs only ~2 spare blocks regardless of
        sequence length. Device-safety: the move list's destinations are
        distinct (each survivor gets its own new slot), and a reclaimed
        block can only become the destination of moves strictly LATER than
        every move reading it (dst ci' ≤ src ci and survivors are processed
        in ci order). gc_compact applies a list with every read before any
        write: its host plan refuses two moves onto one slot and stages
        first the sources that a move's destination overwrites.
        """
        seq = self.seqs[sid]
        g = seq.group
        p = self.page
        # first page containing a hole (or a freed page)
        first = None
        for pg in range(len(seq.blocks)):
            lo, hi = pg * p, min((pg + 1) * p, seq.cache_len)
            if seq.blocks[pg] < 0 or not seq.valid[lo:hi].all():
                first = pg
                break
        if first is None:
            return 0
        survivors = [
            ci for ci in range(first * p, seq.cache_len) if seq.valid[ci]
        ]
        old_blocks = list(seq.blocks)  # by page index
        n_old_pages = len(seq.blocks)
        freed_upto = first  # old pages < freed_upto have been reclaimed
        new_blocks: list[int] = []
        moves = []
        new_valid = seq.valid.copy()
        new_valid[first * p:] = False
        for i, ci in enumerate(survivors):
            nci = first * p + i
            if nci % p == 0:
                # reclaim fully-consumed source pages before claiming
                while freed_upto < ci // p:
                    blk = old_blocks[freed_upto]
                    if blk >= 0:
                        self.block_live[blk] = 0
                        self._free_block(blk, g)
                    freed_upto += 1
                new_blocks.append(self._claim_fresh(g, sid))
            dst_blk = new_blocks[nci // p - first]
            src_blk = old_blocks[ci // p]
            moves.append((src_blk, ci % p, dst_blk, nci % p))
            self.block_live[dst_blk] += 1
            new_valid[nci] = True
        # reclaim remaining old pages
        for pg in range(freed_upto, n_old_pages):
            blk = old_blocks[pg]
            if blk >= 0:
                self.block_live[blk] = 0
                self._free_block(blk, g)
        seq.blocks = old_blocks[:first] + new_blocks
        seq.cache_len = first * p + len(survivors)
        seq.valid = new_valid
        seq.n_dead = 0
        self.copied += len(moves)
        self.pending_moves.extend(moves)
        return len(moves)

    def _claim_fresh(self, g: int, sid: int) -> int:
        if not self.free:
            raise RuntimeError("pool exhausted during compaction")
        blk = self.free.popleft()
        self.block_group[blk] = g
        self.block_seq[blk] = sid
        self.groups[g].n_blocks += 1
        return blk

    # -- Wolf control plane (§5.1/§5.3/§5.5) ----------------------------------------
    def _interval_update(self):
        self.since_interval = 0
        total = sum(st.appends_interval for st in self.groups) or 1
        for st in self.groups:
            u = st.appends_interval / total
            st.p_ewma = st.p_ewma * (1 - self.ewma_a) + self.ewma_a * u
            st.appends_interval = 0
        if self.adaptive:
            self._recompute_alloc()
            self.movement_ops()

    def _recompute_alloc(self):
        s = np.array([max(st.size_slots, 1) for st in self.groups], np.float32)
        p = np.array([st.p_ewma for st in self.groups], np.float32)
        if p.sum() <= 0:
            p = s / s.sum()
        usable = (self.n_blocks - self.reserve - 2 * self.n_groups - 1) * self.page
        op_total = max(usable - float(s.sum()), float(self.n_groups))
        op = allocate_closed_form(
            torch.from_numpy(s), torch.from_numpy(p), op_total
        ).numpy()
        for g, st in enumerate(self.groups):
            st.alloc_blocks = max(1, int(np.ceil((s[g] + op[g]) / self.page)))

    def movement_ops(self):
        """§5.3: compact block-surplus groups greedily, returning blocks to
        the pool for deficit groups (any-to-any donation via the pool)."""
        for _ in range(self.n_blocks):
            excess, g = max(
                (st.n_blocks - st.alloc_blocks, gi)
                for gi, st in enumerate(self.groups)
            )
            if excess < 1 or len(self.free) < 2:
                return
            if self.gc_group(g) == 0:
                return

    # -- integrity (tests) ------------------------------------------------------------
    def check_invariants(self):
        assert (self.block_live >= 0).all()
        live_total = 0
        for sid, seq in self.seqs.items():
            live = int(seq.valid[: seq.cache_len].sum()) if seq.valid is not None else 0
            live_total += live
            for pg, blk in enumerate(seq.blocks):
                if blk >= 0:
                    assert self.block_group[blk] == seq.group
                    assert self.block_seq[blk] == sid
        assert live_total == int(self.block_live.sum())
        for g, st in enumerate(self.groups):
            assert st.n_blocks == int((self.block_group == g).sum())
            assert st.size_slots == int(self.block_live[self.block_group == g].sum())
        assert len(self.free) == int((self.block_group == -1).sum())
