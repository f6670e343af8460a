"""The plain reference: one drive of the SSD simulator, event by event, in
NumPy and Python integers.

It is written from the paper's model (§3 drive, §5 Wolf manager) and keeps
the arithmetic that decides integer outcomes exactly as a float32 program
rounds it: the EWMA of §5.1 with one rounding (a fused multiply-add), the
§5.5 closed form and the hit rates op by op in float32. Nothing here
imports the program under test, JAX, or the JAX package.

One WRITE of page ``lba``:

  1. take the page out of its old slot (its block's live count, its
     group's size), and find its group: the old one, or after a TRIM the
     page's layout group (the first active group when that one merged);
  2. under the bloom detector (§5.6), insert the page into its group's
     active filter, rotate the pair when the group's write count reaches
     its size, and promote the page one group hotter when it was in both;
  3. GC in the target group when it needs a block it is not entitled to or
     the pool is at reserve (§5.4; greedy: the first CLOSED block with the
     fewest live pages), then the emergency valve while the pool is nearly
     empty;
  4. append the page to the group's active block (a fresh block, the
     lowest FREE one, when it is full);
  5. one movement operation (§5.3) on the group of the largest surplus;
  6. every h writes, the §5.1 interval: EWMA, §5.2 create and merge, §5.5.

A GC drains its victim page by page in slot order; under the bloom
detector a page in neither filter of its group moves one group colder.
A TRIM unmaps the page and counts the dead slot in its block.

``precision`` names the float type of every float the model has (the
EWMA, the hit rates, the §5.5 closed form): "float32" is the reference;
"bfloat16" rounds each of those operations to bfloat16, the control that
a run of the program must not pass for.
"""

from __future__ import annotations

import fractions

import numpy as np

FREE, OPEN, CLOSED = 0, 1, 2
INT32_MAX = 2**31 - 1
F32 = np.float32


def bf16(x):
    """Round float32 values to bfloat16 (nearest, ties to even), kept as
    float32."""
    a = np.atleast_1d(np.asarray(x, np.float32)).copy()
    bits = a.view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = rounded.astype(np.uint32).view(np.float32)
    out = np.where(np.isfinite(a), out, a)
    return out.reshape(np.shape(x)) if np.ndim(x) else F32(out[0])


def _round32(q: fractions.Fraction) -> np.float32:
    """The float32 nearest to the exact rational ``q`` (ties to even)."""
    f = np.float32(float(q))
    best = None
    for c in (np.nextafter(f, F32(-np.inf)), f,
              np.nextafter(f, F32(np.inf))):
        err = abs(fractions.Fraction(float(c)) - q)
        if best is None or err < best[0] or (
                err == best[0]
                and int(np.float32(c).view(np.uint32)) % 2 == 0):
            best = (err, F32(c))
    return best[1]


def fma32(x, y, z):
    """``x * y + z`` over float32 arrays with one rounding: the exact
    value, rounded once to float32."""
    x, y, z = (np.broadcast_to(np.asarray(v, F32), np.shape(x)) for v in
               (x, y, z))
    out = np.empty(np.shape(x), F32)
    for i in np.ndindex(out.shape):
        q = (fractions.Fraction(float(x[i])) * fractions.Fraction(float(y[i]))
             + fractions.Fraction(float(z[i])))
        out[i] = _round32(q)
    return out


class Drive:
    """One pre-conditioned drive of a configuration and a first phase.

    ``geom``: n_luns, blocks_per_lun, pages_per_block, lba_pba. ``mgr``:
    the manager's knobs (see ``configs/*.json``). ``sizes``/``probs``: the
    first phase's groups, which lay the drive out and seed the group
    frequencies. ``layout_arrays``: their :func:`layout`, made once for
    many drives (made here when None)."""

    def __init__(self, geom: dict, mgr: dict, sizes, probs, *, with_trim,
                 precision="float32", layout_arrays=None):
        if mgr["gc_policy"] != "greedy" or mgr["alloc_mode"] != "wolf":
            raise ValueError("the reference models greedy GC and the §5.5 "
                             "closed form only")
        self.b = b = int(geom["pages_per_block"])
        self.k = k = int(geom["n_luns"]) * int(geom["blocks_per_lun"])
        self.pba = k * b
        self.lba = int(self.pba * float(geom["lba_pba"]))
        self.f_min = int(geom["n_luns"]) * b
        self.mgr = mgr
        self.g_max = g_max = int(mgr["max_groups"])
        self.h = max(16, int(self.lba * float(mgr["interval_frac"])))
        self.td = mgr["td_mode"]
        self.with_trim = with_trim
        self.round = bf16 if precision == "bfloat16" else (lambda v: v)
        if precision not in ("float32", "bfloat16"):
            raise ValueError(precision)
        n_groups = 1 if g_max == 1 else len(sizes)
        if layout_arrays is None:
            layout_arrays = layout(self.lba, k, b, sizes, n_groups)
        page_group, page_map, slot_lba, group_of, used = (
            a.copy() if isinstance(a, np.ndarray) else a
            for a in layout_arrays)
        self.page_group0 = page_group
        self.page_map = page_map
        self.slot_lba = slot_lba.reshape(k, b)
        self.valid = self.slot_lba >= 0
        self.live = self.valid.sum(1).astype(np.int64)
        self.fill = np.where(np.arange(k) < used, b, 0).astype(np.int64)
        self.state = np.where(np.arange(k) < used, CLOSED, FREE).astype(
            np.int64)
        self.group_of = group_of.astype(np.int64)
        self.stamp = np.where(np.arange(k) < used, np.arange(k), 0).astype(
            np.int64)
        self.erase_count = np.zeros(k, np.int64)
        self.trim_dead = np.zeros(k, np.int64)
        self.active_blk = np.full(g_max, -1, np.int64)
        self.grp_size = np.bincount(page_group, minlength=g_max).astype(
            np.int64)
        self.grp_live = self.grp_size.copy()
        self.grp_phys = np.bincount(group_of[group_of >= 0],
                                    minlength=g_max).astype(np.int64)
        self.grp_alloc = np.maximum(self.grp_phys, 1)
        self.grp_active = np.arange(g_max) < n_groups
        self.grp_p = np.zeros(g_max, F32)
        if n_groups > 1:
            self.grp_p[:len(probs)] = np.asarray(probs, F32)
        self.grp_writes = np.zeros(g_max, np.int64)
        self.grp_created = np.zeros(g_max, np.int64)
        self.free_blocks = int((self.state == FREE).sum())
        self.mapped_pages = self.lba
        self.bits = (max(64, self.lba * int(mgr["bloom_bits_per_page"])
                         // g_max) if self.td == "bloom" else 1)
        self.bloom_active = np.zeros((g_max, self.bits), bool)
        self.bloom_passive = np.zeros((g_max, self.bits), bool)
        self.bloom_writes = np.zeros(g_max, np.int64)
        self.n_app = self.n_mig = self.n_erase = 0
        self.n_dropped = self.n_trim = 0
        self.erase_total = self.erase_sq_total = 0
        self.clock = int(used)
        self.interval = self.cooldown = 0

    # -- the run ------------------------------------------------------------

    def run(self, lbas, ops=None):
        """Every event of the stream in order; returns the cumulative
        (app, mig) counters after each event."""
        n = len(lbas)
        app = np.empty(n, np.int64)
        mig = np.empty(n, np.int64)
        lbas = np.asarray(lbas).tolist()
        ops = [0] * n if ops is None else np.asarray(ops).tolist()
        for i in range(n):
            if ops[i]:
                self.trim(lbas[i])
            else:
                self.write(lbas[i])
            app[i] = self.n_app
            mig[i] = self.n_mig
        return app, mig

    def surplus(self):
        return np.where(self.grp_active, self.grp_phys - self.grp_alloc,
                        -INT32_MAX)

    def hit_rates(self):
        s = np.maximum(self.grp_live.astype(F32), F32(1.0))
        return np.where(self.grp_active, self.round(self.grp_p / s),
                        F32(-1.0)).astype(F32)

    def trim(self, lba):
        pm = int(self.page_map[lba])
        if pm >= 0:
            blk = pm // self.b
            self._leave(blk)
            self.page_map[lba] = -1
            self.valid.flat[pm] = False
            self.trim_dead[blk] += 1
        self.n_trim += 1

    def _leave(self, blk):
        """A mapped page leaves its slot's counts (not its valid bit)."""
        self.live[blk] -= 1
        og = int(self.group_of[blk])
        if og >= 0:
            self.grp_size[og] -= 1
            self.grp_live[og] -= 1
        self.mapped_pages -= 1
        return og

    def write(self, lba):
        pm = int(self.page_map[lba])
        g = self._leave(pm // self.b) if pm >= 0 else 0
        if self.with_trim and pm < 0:
            g = int(self.page_group0[lba])
            if not self.grp_active[g]:
                g = int(np.argmax(self.grp_active))
        if self.td == "bloom":
            old_g = g
            if self._bloom_update(lba, g):
                g = self._hotter(g)
            if not self.grp_active[g]:
                g = old_g
        elif self.td != "static":
            raise ValueError(f"td_mode {self.td!r}")
        if pm >= 0:
            self.valid.flat[pm] = False
        interval = (self.n_app + 1) % self.h == 0
        self._gc("gc", g)
        for _ in range(int(self.mgr["valve_max_tries"])):
            if self.free_blocks >= 2:
                break
            self._gc("valve")
        self._append(lba, g, migration=False)
        self.n_app += 1
        self.grp_writes[g] += 1
        if self.mgr["movement_ops"]:
            self._gc("movement")
        if interval:
            self._interval()

    # -- §5.6 bloom detector ------------------------------------------------

    def _hashes(self, lba):
        u = lba & 0xFFFFFFFF
        return (((u * 2654435761) & 0xFFFFFFFF) % self.bits,
                ((u * 40503 + 99991) & 0xFFFFFFFF) % self.bits)

    def _bloom_update(self, lba, g):
        h1, h2 = self._hashes(lba)
        act, pas = self.bloom_active[g], self.bloom_passive[g]
        in_both = bool(act[h1] and act[h2] and pas[h1] and pas[h2])
        act[h1] = act[h2] = True
        self.bloom_writes[g] += 1
        if self.bloom_writes[g] >= max(int(self.grp_size[g]),
                                       int(self.mgr["bloom_rotate_min_writes"])):
            pas[:] = act
            act[:] = False
            self.bloom_writes[g] = 0
        return in_both

    def _in_neither(self, lba, g):
        h1, h2 = self._hashes(lba)
        act, pas = self.bloom_active[g], self.bloom_passive[g]
        return not (act[h1] and act[h2]) and not (pas[h1] and pas[h2])

    def _hotter(self, g):
        """The next hotter active group in the (hit rate descending, index
        ascending) order; g itself when it is the hottest."""
        hr = self.hit_rates()
        best = None
        for x in np.flatnonzero(self.grp_active).tolist():
            if hr[x] > hr[g] or (hr[x] == hr[g] and x < g):
                if best is None or hr[x] <= hr[best]:
                    best = x  # the lowest rate, ties to the highest index
        return g if best is None else best

    def _colder(self, g, hr):
        """The next colder active group of an active g; g when coldest."""
        best = None
        for x in np.flatnonzero(self.grp_active).tolist():
            if hr[x] < hr[g] or (hr[x] == hr[g] and x > g):
                if best is None or hr[x] > hr[best]:
                    best = x  # the highest rate, ties to the lowest index
        return g if best is None else best

    # -- §5.4 GC --------------------------------------------------------------

    def _gc(self, mode, g=None):
        free0 = self.free_blocks
        if mode == "gc":
            blk = int(self.active_blk[g])
            needs = blk < 0 or self.fill[blk] >= self.b
            enabled = needs and (
                self.grp_phys[g] >= self.grp_alloc[g]
                or free0 <= int(self.mgr["gc_reserve_blocks"]))
        elif mode == "valve":
            score = np.where(self.state == CLOSED, self.live, INT32_MAX)
            g = max(int(self.group_of[int(np.argmin(score))]), 0)
            enabled = True
        else:
            sur = self.surplus()
            g = int(np.argmax(sur))
            enabled = sur[g] >= 1 and free0 >= 2
        if not enabled:
            return
        closed = (self.state == CLOSED) & (self.group_of == g)
        if not closed.any():
            return
        victim = int(np.argmin(np.where(closed, self.live, self.b + 1)))
        if self.live[victim] >= self.b or free0 < 1:
            return
        self._drain(victim, g)

    def _drain(self, victim, g):
        """Move every live page of ``victim`` (slot order) into its target
        group, then erase the block."""
        for j in range(self.b):
            if not self.valid[victim, j]:
                continue
            lba = int(self.slot_lba[victim, j])
            self.valid[victim, j] = False
            self.live[victim] -= 1
            tgt = g
            if self.td == "bloom" and self._in_neither(lba, g):
                tgt = self._colder(g, self.hit_rates())
            self.grp_size[g] -= 1
            self.grp_live[g] -= 1
            self.mapped_pages -= 1
            self._append(lba, tgt, migration=True)
        e = int(self.erase_count[victim])
        self.state[victim] = FREE
        self.group_of[victim] = -1
        self.fill[victim] = 0
        self.live[victim] = 0
        self.stamp[victim] = self.clock
        self.trim_dead[victim] = 0
        self.slot_lba[victim] = -1
        self.valid[victim] = False
        self.clock += 1
        self.grp_phys[g] -= 1
        self.free_blocks += 1
        self.n_erase += 1
        self.erase_count[victim] = e + 1
        self.erase_total += 1
        self.erase_sq_total += 2 * e + 1

    def _append(self, lba, g, *, migration):
        b = self.b
        blk = int(self.active_blk[g])
        if blk < 0 or self.fill[blk] >= b:
            if blk >= 0:
                self.state[blk] = CLOSED
            free = np.flatnonzero(self.state == FREE)
            if len(free):
                nb = int(free[0])
                self.grp_phys[g] += 1
                self.state[nb] = OPEN
                self.group_of[nb] = g
                self.fill[nb] = 0
                self.stamp[nb] = self.clock
                self.free_blocks -= 1
                self.clock += 1
                self.active_blk[g] = blk = nb
        if blk < 0 or self.fill[blk] >= b:
            self.page_map[lba] = -1
            self.n_dropped += 1
            return
        slot = int(self.fill[blk])
        self.slot_lba[blk, slot] = lba
        self.valid[blk, slot] = True
        self.fill[blk] += 1
        self.live[blk] += 1
        self.page_map[lba] = blk * b + slot
        self.grp_size[g] += 1
        self.grp_live[g] += 1
        self.mapped_pages += 1
        if migration:
            self.n_mig += 1

    # -- §5.1 interval, §5.2 groups, §5.5 allocation -------------------------

    def _interval(self):
        r = self.round
        a = F32(self.mgr["ewma_a"])
        u = r(self.grp_writes.astype(F32) / F32(self.h))
        p = fma32(self.grp_p, r(F32(1.0) - a), r(a * u))
        self.grp_p = np.where(self.grp_active, r(p), F32(0.0)).astype(F32)
        self.grp_writes[:] = 0
        self.interval += 1
        self.cooldown = max(self.cooldown - 1, 0)
        if self.mgr["dynamic_groups"]:
            self._create_or_merge()
        self._allocate()

    def _create_or_merge(self):
        r = self.round
        w = int(self.mgr["w_intervals"])
        hr = self.hit_rates()
        order = np.argsort(-hr, kind="stable")
        hot, second = int(order[0]), int(order[1])
        n_active = int(self.grp_active.sum())
        ratio = r(hr[hot] / max(hr[second], F32(1e-12)))
        if (n_active < int(self.mgr["max_groups"]) and self.cooldown == 0
                and n_active >= 2 and ratio >= F32(self.mgr["q_create"])
                and self.grp_size[hot] >= self.f_min):
            slot = int(np.argmin(self.grp_active))
            self.grp_active[slot] = True
            self.grp_phys[slot] = 0
            self.grp_p[slot] = r(self.grp_p[hot] * F32(0.5))
            self.grp_size[slot] = 0
            self.grp_live[slot] = 0
            self.grp_created[slot] = self.interval
            self.cooldown = w
        hr = self.hit_rates()
        order = np.argsort(-hr, kind="stable")
        n_active = int(self.grp_active.sum())
        hs = hr[order]
        nxt = np.roll(hs, -1)
        pair = np.arange(self.g_max) + 1 < n_active
        ratio = r(hs / np.maximum(nxt, F32(1e-12)))
        merge = ((pair & (ratio < F32(1.3)) & (hs > 0))
                 | (pair & (self.grp_size[order] < self.f_min) & (nxt > 0)))
        i = int(np.argmax(merge))
        if not (merge[i] and self.cooldown == 0 and n_active > 2):
            return
        src, dst = int(order[i]), int(order[min(i + 1, self.g_max - 1)])
        self.group_of[self.group_of == src] = dst
        ab = int(self.active_blk[src])
        if ab >= 0:
            self.state[ab] = CLOSED
        for arr in (self.grp_size, self.grp_live, self.grp_phys,
                    self.grp_writes):
            arr[dst] += arr[src]
            arr[src] = 0
        self.grp_p[dst] = r(self.grp_p[dst] + self.grp_p[src])
        self.grp_p[src] = 0
        self.active_blk[src] = -1
        self.grp_active[src] = False
        self.cooldown = w

    def _allocate(self):
        """§5.5: each active group's OP by the closed form (eq. 8) with the
        cold-group rule, in blocks."""
        r = self.round
        mgr, b = self.mgr, self.b
        act = self.grp_active
        s = np.where(act, self.grp_live.astype(F32), F32(0.0))
        s = np.maximum(s, act.astype(F32))
        p = np.where(act, self.grp_p, F32(0.0)).astype(F32)
        p = r(p / max(fsum32(p, r), F32(1e-9)))
        n_active = int(act.sum())
        op_total = r(F32(self.pba) - F32((int(mgr["gc_reserve_blocks"]) + 1
                                          + n_active) * b))
        op_total = r(op_total - fsum32(s, r))
        op = closed_form_alloc(s, p, op_total, F32(mgr["cold_hit_rate_frac"]),
                               F32(mgr["cold_op_frac"]), r)
        blocks = np.ceil(r(r(s + op) / F32(b))).astype(np.int64)
        self.grp_alloc = np.where(act, np.maximum(blocks, 1), 0)

    # -- what is compared ----------------------------------------------------

    def fields(self) -> dict:
        """The drive's state, by the names a fleet's final state uses."""
        out = {k: getattr(self, k) for k in (
            "page_map", "slot_lba", "valid", "live", "fill", "stamp",
            "state", "group_of", "erase_count", "trim_dead", "active_blk",
            "grp_size", "grp_phys", "grp_p", "grp_writes", "grp_alloc",
            "grp_active", "grp_created", "grp_live", "bloom_writes")}
        out["grp_surplus"] = self.surplus()
        if self.td == "bloom":
            out["bloom_active"] = self.bloom_active
            out["bloom_passive"] = self.bloom_passive
        for k in ("free_blocks", "mapped_pages", "n_app", "n_mig", "n_erase",
                  "n_dropped", "n_trim", "erase_total", "erase_sq_total",
                  "clock", "interval", "cooldown"):
            out[k] = np.asarray(getattr(self, k))
        return out


def fsum32(x, r=lambda v: v):
    """Left-to-right float32 sum of a short vector."""
    acc = F32(x[0])
    for v in x[1:]:
        acc = r(F32(acc + F32(v)))
    return acc


def closed_form_alloc(s, p, op_total, cold_hit, cold_op_frac, r):
    """Eq. (8), (s·V + p·OP)/2 with V = OP/Σs, and §5.5.3's cold group:
    when the coldest group (by p/s, the first of equals) is under
    ``cold_hit`` of the second's rate and takes under 2% of the writes, it
    gets ``cold_op_frac`` of the smallest group's size and the rest is
    split by eq. (8)."""

    def eq8(s, p, op):
        v = r(op / fsum32(s, r))
        pn = r(p / max(fsum32(p, r), F32(1e-30)))
        return r(F32(0.5) * r(r(s * v) + r(pn * op)))

    base = eq8(s, p, op_total)
    if len(s) < 2:
        return base
    hit = r(p / np.maximum(s, F32(1e-30)))
    order = np.argsort(hit, kind="stable")
    c0, c1 = int(order[0]), int(order[1])
    share = r(p[c0] / max(fsum32(p, r), F32(1e-30)))
    if not (hit[c0] < r(cold_hit * hit[c1]) and share < F32(0.02)):
        return base
    cold = min(r(cold_op_frac * s.min()), op_total)
    mask = np.arange(len(s)) != c0
    rest = eq8(np.where(mask, s, F32(0)).astype(F32),
               np.where(mask, p, F32(0)).astype(F32), r(op_total - cold))
    return np.where(mask, rest, cold).astype(F32)


def split_sizes(lba: int, fracs) -> list[int]:
    """Group sizes in pages: each fraction of the logical span rounded
    down, the last group taking the remainder."""
    fracs = np.asarray(fracs, np.float64)
    fracs = fracs / fracs.sum()
    sizes = np.floor(fracs * lba).astype(np.int64)
    sizes[-1] += lba - sizes.sum()
    return [int(v) for v in sizes]


def layout(lba: int, k: int, b: int, sizes, n_groups: int):
    """The pre-conditioned drive: pages in group order, block after block.
    A page of a new group opens a new block when the current block holds
    pages already, and that page's group becomes the current one; a group
    that begins on an empty block therefore places its first page alone
    there (the current group is still the previous one) and its second
    page opens the next block. Returns (page_group, page_map, slot_lba
    [K·B], group_of, blocks used)."""
    if n_groups == 1:
        page_group = np.zeros(lba, np.int64)
    else:
        page_group = np.repeat(np.arange(len(sizes)), sizes)
    page_map = np.full(lba, -1, np.int64)
    slot_lba = np.full(k * b, -1, np.int64)
    group_of = np.full(k, -1, np.int64)
    blk = slot = 0
    cur = int(page_group[0])
    start = 0
    while start < lba:
        g = int(page_group[start])
        end = int(np.searchsorted(page_group, g, side="right"))
        i = start
        while i < end:
            if g != cur and slot > 0:
                blk, slot, cur = blk + 1, 0, g
            if slot == 0:
                group_of[blk] = g
            if g != cur:  # one page alone, then the rule again
                page_map[i] = blk * b + slot
                slot_lba[blk * b + slot] = i
                slot += 1
                if slot == b:
                    blk, slot = blk + 1, 0
                i += 1
                continue
            n = min(end - i, b - slot)  # the rest of this block
            page_map[i:i + n] = blk * b + slot + np.arange(n)
            slot_lba[blk * b + slot: blk * b + slot + n] = np.arange(i, i + n)
            slot += n
            if slot == b:
                blk, slot = blk + 1, 0
            i += n
        start = end
    if slot > 0:
        blk += 1
    return page_group, page_map, slot_lba, group_of, blk
