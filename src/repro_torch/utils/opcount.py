"""Count a program's work as it runs: flops, bytes, peak live bytes and
collective bytes, on any device (the counterpart of ``repro.utils.hlo``'s
``analyze_hlo`` and ``attribute``, which read them off compiled HLO text;
PyTorch runs eagerly, so the counts come from the ops as they dispatch).

    with OpCounter(resident_bytes=state_bytes) as c:
        step(state, batch)
    c.result()  # {"flops", "bytes", "collective_bytes", "peak_bytes", ...}

On the meta device nothing is computed and nothing allocated, so a
full-size step is counted in seconds on any host.

* flops: ``torch.utils.flop_counter``'s registry (mm, bmm, addmm,
  baddbmm, convolutions, SDPA): 2 · M · N · K a product; elementwise flops
  are not counted, as ``analyze_hlo`` counts only ``dot``.
* bytes: each aten op's inputs plus its outputs; views and ops that
  allocate without writing (``empty`` and the like) are free.
* peak live bytes: ``resident_bytes`` (what lived before the count began)
  plus every storage an op creates, until it is freed (a weakref finalizer
  on the storage).
* collective bytes: the payload of every c10d op (0 on one card).
* hand-written kernels: a ctypes launch is invisible to a dispatch mode,
  so a kernel's wrapper calls :func:`record_kernel` with its own cost
  formula on every call, on the card and on the meta route alike.

Trip counts: :func:`repeat` multiplies the counts of the ops inside it,
and of their backward, by a loop's trip count (``models.common.scan``
runs a recurrence's body once under it on the meta device), as
``analyze_hlo`` multiplies a ``while`` body by its known trip count.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops that allocate without moving data, or only re-read metadata
_FREE_OPS = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten._unsafe_view, aten.detach, aten.lift_fresh,
    aten.alias, aten.sym_size, aten.sym_stride, aten.sym_numel,
    aten.sym_storage_offset, aten.is_same_size, aten.resize_,
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

# the counters that are active (entered and not yet left), outermost first
_ACTIVE: list["OpCounter"] = []


def active() -> "OpCounter | None":
    """The innermost active counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """A dispatch mode that counts what every aten op does (see the module
    docstring). ``resident_bytes``: bytes alive when the count begins
    (parameters, optimizer state, inputs), the floor of the peak."""

    def __init__(self, resident_bytes: int = 0):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collective_bytes = 0
        self.bytes_by_op: dict[str, float] = defaultdict(float)
        self.collectives: dict[str, dict] = defaultdict(
            lambda: {"count": 0, "bytes": 0})
        self.kernels: dict[str, dict] = defaultdict(
            lambda: {"calls": 0, "flops": 0, "bytes": 0})
        self.resident_bytes = int(resident_bytes)
        self.live_bytes = self.resident_bytes
        self.peak_bytes = self.resident_bytes
        self._mult = 1
        self._live: dict[int, int] = {}  # id(storage) -> bytes it counts
        self._made: list[set[int]] = []  # storages made in each repeat
        self._lock = threading.Lock()

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        outs = _tensors(out)
        name = str(packet)
        m = self._mult
        if func.namespace in _COLLECTIVE_NAMESPACES:
            payload = sum(_nbytes(t) for t in ins) * m
            self.collective_bytes += payload
            self.collectives[name]["count"] += m
            self.collectives[name]["bytes"] += payload
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out) * m
        if not (func.is_view or packet in _FREE_OPS):
            b = (sum(_nbytes(t) for t in ins)
                 + sum(_nbytes(t) for t in outs)) * m
            self.bytes += b
            self.bytes_by_op[name] += b
        self._track(ins, outs)
        return out

    # -- live storages ---------------------------------------------------------
    def _track(self, ins, outs) -> None:
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._live:
                continue
            seen.add(key)
            size = st.nbytes()
            with self._lock:
                self._live[key] = size
                self.live_bytes += size
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            if self._made:
                self._made[-1].add(key)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0)

    # -- records -----------------------------------------------------------------
    def record(self, name: str, flops: float, nbytes: float) -> None:
        """One call of a hand-written kernel with its own cost."""
        m = self._mult
        self.flops += flops * m
        self.bytes += nbytes * m
        self.bytes_by_op[name] += nbytes * m
        k = self.kernels[name]
        k["calls"] += m
        k["flops"] += flops * m
        k["bytes"] += nbytes * m

    def result(self) -> dict:
        """The counts, keyed as ``analyze_hlo``'s result, plus the peak and
        the hand-written kernels' records."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "peak_bytes": self.peak_bytes,
            "resident_bytes": self.resident_bytes,
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "bytes_by_op": dict(self.bytes_by_op),
        }


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """Add one call of a hand-written kernel to every active counter."""
    for c in _ACTIVE:
        c.record(name, flops, nbytes)


def attribute(counter: OpCounter) -> tuple[dict, dict]:
    """(bytes by op, collective bytes by op), each already multiplied by
    its trip counts, as ``repro.utils.hlo.attribute``."""
    return (dict(counter.bytes_by_op),
            {k: v["bytes"] for k, v in counter.collectives.items()})


# -- trip counts -------------------------------------------------------------

def _sequence_mark() -> int:
    """The autograd sequence number of a node made now: every node made
    later in this thread has a larger one."""
    with torch.enable_grad():
        probe = torch.empty(0, device="meta", requires_grad=True).view(0)
    return probe.grad_fn._sequence_nr()


class _Repeat:
    """One loop run as its body once: see :func:`repeat`."""

    def __init__(self, n: int, counters: list[OpCounter]):
        self.n = n
        self.counters = counters
        self.mark = _sequence_mark() if torch.is_grad_enabled() else None
        self.outputs = None

    def _scale(self, up: bool) -> None:
        for c in self.counters:
            c._mult = c._mult * self.n if up else c._mult // self.n

    def finish(self, carry, ys) -> None:
        """Hand over the body's outputs: its carry and its step output."""
        self.outputs = (carry, ys)

    def _close(self) -> None:
        """What the body made and left alive (its outputs, the tensors
        autograd saved) exists n times in the loop, but for the carry, of
        which one lives on unless autograd keeps each step's (it then
        requires a gradient). The body's backward nodes run under the trip
        count too."""
        made = [c._made.pop() for c in self.counters]
        if self.outputs is None:  # the body raised
            return
        carry, ys = self.outputs
        self.outputs = None  # the hooks below keep this object alive
        kept = {id(t.untyped_storage()) for t in _tensors(ys)}
        keep_one = {id(t.untyped_storage()) for t in _tensors(carry)
                    if not t.requires_grad} - kept
        for c, keys in zip(self.counters, made):
            with c._lock:
                for key in keys:
                    if key in c._live and key not in keep_one:
                        extra = c._live[key] * (self.n - 1)
                        c._live[key] += extra
                        c.live_bytes += extra
                c.peak_bytes = max(c.peak_bytes, c.live_bytes)
            if c._made:  # an enclosing loop made them too
                c._made[-1].update(keys)
        if self.mark is not None:
            self._hook_backward(_tensors((carry, ys)))

    def _hook_backward(self, outputs) -> None:
        stack = [t.grad_fn for t in outputs if t.grad_fn is not None]
        seen = set()
        while stack:
            node = stack.pop()
            if node is None or node in seen:
                continue
            seen.add(node)
            if (type(node).__name__ == "AccumulateGrad"
                    or node._sequence_nr() <= self.mark):
                continue
            out = [f is None or type(f).__name__ == "AccumulateGrad"
                   or f._sequence_nr() <= self.mark
                   for f, _ in node.next_functions]
            node.register_prehook(lambda grads, r=self: r._scale(True))
            node.register_hook(
                lambda gin, gout, r=self, out=out: r._leave(gin, out))
            stack.extend(f for f, _ in node.next_functions)

    def _leave(self, grads, leaving) -> None:
        """A body node's backward ends. A gradient it sends out of the body
        is summed there with the other steps': the loop adds n - 1 more
        than the one step run here (an add reads two, writes one)."""
        for c in self.counters:
            outer = c._mult // self.n
            for g, out in zip(grads, leaving):
                if out and g is not None:
                    b = 3 * _nbytes(g) * (self.n - 1) * outer
                    c.bytes += b
                    c.bytes_by_op["aten.add"] += b
        self._scale(False)


@contextlib.contextmanager
def repeat(n: int):
    """Multiply the counts of the ops run inside by ``n`` (a loop's trip
    count), on every active counter, and of their backward. Yields a
    handle; the caller passes the body's outputs to its ``finish(carry,
    ys)``."""
    r = _Repeat(n, list(_ACTIVE))
    for c in r.counters:
        c._made.append(set())
    r._scale(True)
    try:
        yield r
    finally:
        r._scale(False)
        r._close()
