"""The port's op count (``repro_torch.utils.opcount``) and the recurrences'
trip-count rule (``models.common.scan``), mirroring the JAX package's HLO
analyzer tests (tests/test_hlo_analyzer.py): one matmul, a loop-free
chain held against ``analyze_hlo`` on the JAX program, a scanned loop and
a nested one, and elementwise bytes; plus the flash kernel's meta route.

Bounds: flops exactly 2·M·N·K a product and equal to ``analyze_hlo``'s
flops on the same chain; a loop's flops and bytes on the meta device
(its body counted once, times the trip count) equal the full loop's on
the CPU exactly, nested too, and its peak live bytes within 10%; with a
backward through the loop, flops and bytes within 3%; views cost no
bytes; the flash route on meta records ``kernel.cost`` once a call.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.utils.hlo import analyze_hlo
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import ssm
from repro_torch.models.attention import _mask, chunked_attention
from repro_torch.models.common import scan
from repro_torch.utils import opcount
from repro_torch.utils.opcount import OpCounter


def _t(shape, device, requires_grad=False):
    if device == "meta":
        t = torch.empty(shape, device="meta")
    else:
        t = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    return t.requires_grad_(requires_grad)


def test_single_matmul_exact():
    m, k, n = 128, 256, 512
    with OpCounter() as c:
        _t((m, k), "meta") @ _t((k, n), "meta")
    assert c.flops == 2 * m * k * n
    assert c.bytes == (m * k + k * n + m * n) * 4


def test_chain_agrees_with_analyze_hlo():
    shapes = [(64, 128), (128, 256), (256, 32)]
    compiled = jax.jit(lambda a, b, c: (a @ b) @ c).lower(
        *(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)).compile()
    want = analyze_hlo(compiled.as_text())["flops"]
    with OpCounter() as c:
        a, b, d = (_t(s, "meta") for s in shapes)
        (a @ b) @ d
    assert c.flops == want == 2 * 64 * 128 * 256 + 2 * 64 * 256 * 32


def _tanh_loop(w, x, n):
    def body(x, i):
        x = torch.tanh(x @ w)
        return x, x

    return scan(body, x, n)


@pytest.mark.parametrize("n", [24, 64])
def test_scan_multiplies_by_trip_count(n):
    m = 32
    counts = {}
    for device in ("cpu", "meta"):
        w, x = _t((m, m), device), _t((m, m), device)
        with OpCounter() as c:
            x, ys = _tanh_loop(w, x, n)
            torch.stack(ys)
        counts[device] = c.result()
    assert counts["meta"]["flops"] == counts["cpu"]["flops"] == n * 2 * m**3
    assert counts["meta"]["bytes"] == counts["cpu"]["bytes"]
    assert counts["meta"]["peak_bytes"] == pytest.approx(
        counts["cpu"]["peak_bytes"], rel=0.1)


def test_nested_scan():
    outer, inner, m = 4, 6, 16

    def run(device):
        w = _t((m, m), device)

        def outer_body(x, i):
            def inner_body(x, j):
                x = x @ w
                return x, x

            x, _ = scan(inner_body, x, inner)
            return x, x

        x = _t((m, m), device)
        with OpCounter() as c:
            scan(outer_body, x, outer)
        return c.result()

    cpu, meta = run("cpu"), run("meta")
    assert meta["flops"] == cpu["flops"] == outer * inner * 2 * m**3
    assert meta["bytes"] == cpu["bytes"]


def test_recurrences_count_their_full_loops():
    """The sLSTM and both mLSTM forms at S = 64: forward exact; with a
    backward through them, within 3%."""
    def run(device, grad):
        cell = ssm.SLSTMCell(32, 2, 16, torch.float32, device)
        mcell = ssm.MLSTMCell(32, 2, 16, torch.float32, device)
        for mod in (cell, mcell):
            for p in mod.parameters():
                p.data = _t(p.shape, device)
            mod.requires_grad_(grad)
        x = _t((2, 64, 32), device)
        with OpCounter() as c:
            y, _ = ssm.slstm_apply(cell, x)
            y2 = ssm.mlstm_sequential(mcell, x)
            y3, _ = ssm.mlstm_chunked(mcell, x, chunk=16)
            if grad:
                torch.autograd.grad(
                    y.sum() + y2.sum() + y3.sum(),
                    [*cell.parameters(), *mcell.parameters()],
                    allow_unused=True)
        return c.result()

    fwd = run("cpu", False), run("meta", False)
    for key in ("flops", "bytes"):
        assert fwd[1][key] == fwd[0][key], key
    bwd = run("cpu", True), run("meta", True)
    for key in ("flops", "bytes", "peak_bytes"):
        assert bwd[1][key] == pytest.approx(bwd[0][key], rel=0.03), key


def test_scan_loops_outside_a_count():
    calls = []

    def body(c, i):
        calls.append(i)
        return c + 1, c

    carry, ys = scan(body, torch.zeros((), device="meta"), 5)
    assert calls == [0, 1, 2, 3, 4] and len(ys) == 5
    calls.clear()
    with OpCounter():
        scan(body, torch.zeros((), device="meta"), 5)
    assert calls == [0, 1]  # step 0, then step 1 for the other four


def test_views_are_free_and_elementwise_bytes():
    n = 1 << 12
    a, b = _t((n,), "meta"), _t((n,), "meta")
    m = _t((64, 64), "meta")
    with OpCounter() as c:
        m.t()
        m.view(4096)
        m[:, 3]
        m.transpose(0, 1).reshape(4096)  # a copy: counted
        a * 2.0 + b
    by_op = c.bytes_by_op
    assert "aten.t" not in by_op and "aten.view" not in by_op
    assert "aten.select" not in by_op
    assert by_op["aten.clone"] == 2 * 64 * 64 * 4
    assert by_op["aten.mul"] == 2 * n * 4 and by_op["aten.add"] == 3 * n * 4
    assert c.flops == 0


@pytest.mark.parametrize("causal,window,sq,skv", [
    (True, 0, 64, 64), (True, 16, 64, 64), (False, 0, 24, 64),
    (True, 8, 40, 64), (False, 12, 48, 48)])
def test_flash_cost_counts_the_mask(causal, window, sq, skv):
    pairs = int(torch.broadcast_to(_mask(
        torch.arange(sq), torch.arange(skv), window, causal),
        (sq, skv)).sum())
    q, k = _t((2, sq, 4, 32), "meta"), _t((2, skv, 2, 32), "meta")
    flops, nbytes = flash_kernel.cost(q, k, causal, window)
    assert flops == 4 * 2 * 4 * 32 * pairs
    assert nbytes == (2 * q.numel() + 2 * k.numel()) * 4


def test_flash_meta_route_records_cost_once_a_call():
    q = _t((2, 64, 4, 64), "meta").bfloat16()
    k, v = (_t((2, 64, 2, 64), "meta").bfloat16() for _ in range(2))
    with OpCounter() as c:
        out = flash_attention(q, k, v, causal=True, window=16)
        assert out.shape == q.shape and out.is_meta
        chunked_attention(q, k, v, 16, window_static=16)
        chunked_attention(q, k, v, 16)  # no static window: the plain path
    rec = c.kernels["flash_attention"]
    flops, nbytes = flash_kernel.cost(q, k, True, 16)
    assert rec == {"calls": 2, "flops": 2 * flops, "bytes": 2 * nbytes}
    assert c.flops > 2 * flops  # the plain path's products besides
    # the CPU runs the plain version and records nothing
    with OpCounter() as c:
        flash_attention(*(torch.zeros(t.shape, dtype=torch.bfloat16)
                          for t in (q, k, v)), causal=True)
    assert not c.kernels and c.flops > 0
    # outside a count, nothing is recorded anywhere
    assert opcount.active() is None
    flash_attention(q, k, v)


def test_peak_and_attribute():
    with OpCounter(resident_bytes=1000) as c:
        x = torch.empty(256, device="meta")
        y = x * 2
        del x, y
        z = torch.empty(16, device="meta") + 1
    assert c.peak_bytes == 1000 + 2 * 256 * 4
    assert c.live_bytes == 1000 + 16 * 4  # the empty operand died
    assert c.collective_bytes == 0 and isinstance(z, torch.Tensor)
    by_op, coll = opcount.attribute(c)
    assert by_op["aten.mul"] == 2 * 256 * 4 and coll == {}
