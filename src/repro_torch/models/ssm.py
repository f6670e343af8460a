"""Recurrent sequence mixers: Mamba (selective SSM), mLSTM, sLSTM (the
counterpart of ``repro.models.ssm``).

Each mixer keeps two forms, as the JAX package does:

* a *sequential* reference (a Python loop over time), the oracle;
* a *chunkwise-parallel* form, the one the models run: Mamba's scan is a
  log-depth (Hillis–Steele) scan over each chunk's time axis, every chunk
  at once, then the state carried over the chunks; the mLSTM runs
  intra-chunk attention with log-space gate stabilisation, chunk after
  chunk. Chunk boundaries carry the recurrent state.

The sLSTM has only the sequential form: its memory mixing is serial.
Every recurrence runs in fp32 whatever the model's dtype. Where the JAX
package's ``lax.associative_scan`` and the scan here combine in another
tree, sums round differently (within 1e-5 relative at the tests' sizes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import _param, dense_init, scan

F32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) everywhere
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ===========================================================================
# Mamba (selective SSM), Hymba's SSM heads. State: h [B, D, N], conv
# history [B, k-1, D] (the pre-conv inputs).
# ===========================================================================

class Mamba(nn.Module):
    """in_proj [d, 2D], x_dt [D, R], x_bc [D, 2N], out_proj [D, d] in the
    model's dtype; conv_w [k, D], dt_proj [R, D], dt_bias [D], a_log
    [D, N], d_skip [D] in fp32 (R = max(1, d // 16))."""

    def __init__(self, d_model: int, d_inner: int, n_state: int,
                 conv_k: int, dtype, device):
        super().__init__()
        dt_rank = max(1, d_model // 16)
        self.in_proj = _param((d_model, 2 * d_inner), dtype, device)
        self.conv_w = _param((conv_k, d_inner), F32, device)
        self.x_dt = _param((d_inner, dt_rank), dtype, device)
        self.dt_proj = _param((dt_rank, d_inner), F32, device)
        self.dt_bias = _param((d_inner,), F32, device)
        self.x_bc = _param((d_inner, 2 * n_state), dtype, device)
        self.a_log = _param((d_inner, n_state), F32, device)
        self.d_skip = _param((d_inner,), F32, device)
        self.out_proj = _param((d_inner, d_model), dtype, device)

    def init_(self, generator) -> None:
        for t in (self.in_proj, self.conv_w, self.x_dt, self.dt_proj,
                  self.x_bc, self.out_proj):
            dense_init(t, generator)
        self.conv_w.mul_(0.5)
        d_inner, n_state = self.a_log.shape
        dev = self.a_log.device
        self.dt_bias.copy_(torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, d_inner, device=dev))))
        self.a_log.copy_(torch.log(
            torch.arange(1, n_state + 1, dtype=F32, device=dev)).expand(
                d_inner, n_state))
        self.d_skip.fill_(1.0)


def _mamba_dt_bc(m: Mamba, u):
    """(dt, Bmat, Cmat) from the conv'd input u [..., D] (fp32)."""
    dt = softplus((u @ m.x_dt.float()) @ m.dt_proj + m.dt_bias)
    bmat, cmat = (u @ m.x_bc.float()).chunk(2, dim=-1)
    return dt, bmat, cmat


def _mamba_gates(m: Mamba, x):
    """x [B, S, d] -> (u [B, S, D] conv'd and silu'd input, z gate, dt,
    Bmat, Cmat, u_raw the pre-conv input: the decode conv history)."""
    u_raw, z = (x @ m.in_proj).chunk(2, dim=-1)
    k, s = m.conv_w.shape[0], u_raw.shape[1]
    pad = F.pad(u_raw.float(), (0, 0, k - 1, 0))
    conv = 0  # a causal depthwise conv over time, summed tap by tap
    for i in range(k):
        conv = conv + pad[:, i:i + s] * m.conv_w[i]
    u = F.silu(conv)
    return (u, z, *_mamba_dt_bc(m, u), u_raw)


def _prefix_scan(a, b, dim: int):
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t along ``dim`` from h = 0,
    log-depth (Hillis–Steele) with the combine (a1·a2, a2·b1 + b2).
    Returns the running products of a and the running states."""
    n = a.shape[dim]
    off = 1
    while off < n:
        a_prev, b_prev = a.narrow(dim, 0, n - off), b.narrow(dim, 0, n - off)
        a_cur, b_cur = a.narrow(dim, off, n - off), b.narrow(dim, off, n - off)
        a = torch.cat([a.narrow(dim, 0, off), a_prev * a_cur], dim)
        b = torch.cat([b.narrow(dim, 0, off), a_cur * b_prev + b_cur], dim)
        off *= 2
    return a, b


def _mamba_scan_chunked(u, dt, bmat, cmat, a_log, h0, chunk: int):
    """The diagonal SSM h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t·u_t, y_t =
    C_t·h_t over u, dt [B, S, D] and Bmat, Cmat [B, S, N] from h0 [B, D,
    N]. Returns (y [B, S, D], h after the last step).

    The JAX package's chunk rule: ``s // chunk`` chunks (at least one),
    evened out to ``s // n`` when that divides S (so S < 2·chunk is one
    chunk), else chunks of ``chunk`` with the tail zero-padded. Each
    chunk's scan runs in parallel; h is then carried chunk to chunk."""
    b, s, d = u.shape
    a = -torch.exp(a_log)  # [D, N], negative for stability
    n_chunks = max(1, s // chunk)
    chunk = s // n_chunks if s % n_chunks == 0 else chunk
    pad = (-s) % chunk
    if pad:
        u, dt, bmat, cmat = (F.pad(t, (0, 0, 0, pad))
                             for t in (u, dt, bmat, cmat))
    nc = u.shape[1] // chunk

    def chunks(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    uc, dtc, bc, cc = map(chunks, (u, dt, bmat, cmat))
    decay = torch.exp(dtc[..., None] * a)  # [B, nc, c, D, N]
    inp = (dtc * uc)[..., None] * bc[:, :, :, None, :]
    acc_a, acc_b = _prefix_scan(decay, inp, dim=2)
    def carry_on(h, j):  # the state entering chunk j + 1
        h = acc_a[:, j, -1] * h + acc_b[:, j, -1]
        return h, h

    _, h_in = scan(carry_on, h0, nc - 1)
    h_all = acc_a * torch.stack([h0, *h_in], 1)[:, :, None] + acc_b
    y = torch.einsum("bjcdn,bjcn->bjcd", h_all, cc)
    # a copy: a view of h_all would keep all of it alive in the caller's cache
    return y.reshape(b, nc * chunk, d)[:, :s], h_all[:, -1, -1].clone()


def mamba_apply(m: Mamba, x, *, chunk: int = 64):
    """x [B, S, d] -> [B, S, d] from a fresh state."""
    u, z, dt, bmat, cmat, _ = _mamba_gates(m, x)
    d, n = m.a_log.shape
    h0 = torch.zeros((x.shape[0], d, n), dtype=F32, device=x.device)
    y, _ = _mamba_scan_chunked(u, dt, bmat, cmat, m.a_log, h0, chunk)
    y = (y + u * m.d_skip) * F.silu(z.float())
    return y.to(x.dtype) @ m.out_proj


def mamba_init_state(m: Mamba, batch: int) -> dict:
    d, n = m.a_log.shape
    k = m.conv_w.shape[0]
    dev = m.a_log.device
    return {"h": torch.zeros((batch, d, n), dtype=F32, device=dev),
            "conv": torch.zeros((batch, k - 1, d), dtype=F32, device=dev)}


def mamba_decode_step(m: Mamba, state: dict, x_t):
    """x_t [B, d] one token. Returns (y [B, d], new state)."""
    u, z = (x_t @ m.in_proj).chunk(2, dim=-1)
    hist = torch.cat([state["conv"], u.float()[:, None]], dim=1)  # [B, k, D]
    u_ = F.silu(torch.einsum("bkd,kd->bd", hist, m.conv_w))
    dt, bmat, cmat = _mamba_dt_bc(m, u_)
    decay = torch.exp(dt[..., None] * -torch.exp(m.a_log))  # [B, D, N]
    h = decay * state["h"] + (dt * u_)[..., None] * bmat[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, cmat) + u_ * m.d_skip
    y = y * F.silu(z.float())
    return y.to(x_t.dtype) @ m.out_proj, {"h": h, "conv": hist[:, 1:]}


# ===========================================================================
# mLSTM (xLSTM's matrix-memory cell). State: (C [B, H, Dh, Dh], n [B, H,
# Dh], m [B, H]).
# ===========================================================================

class MLSTMCell(nn.Module):
    """wq / wk / wv [d, H, Dh] and w_o [d, H·Dh] in the model's dtype;
    the gates w_i / w_f [d, H] and f_bias [H] in fp32."""

    def __init__(self, d_model: int, n_heads: int, d_head: int, dtype,
                 device):
        super().__init__()
        self.wq = _param((d_model, n_heads, d_head), dtype, device)
        self.wk = _param((d_model, n_heads, d_head), dtype, device)
        self.wv = _param((d_model, n_heads, d_head), dtype, device)
        self.w_i = _param((d_model, n_heads), F32, device)
        self.w_f = _param((d_model, n_heads), F32, device)
        self.f_bias = _param((n_heads,), F32, device)
        self.w_o = _param((d_model, n_heads * d_head), dtype, device)

    def init_(self, generator) -> None:
        for t in (self.wq, self.wk, self.wv, self.w_i, self.w_f, self.w_o):
            dense_init(t, generator)
        self.w_i.mul_(0.1)
        self.w_f.mul_(0.1)
        self.f_bias.fill_(3.0)  # start remembering


def _mlstm_qkvif(cell: MLSTMCell, x):
    """x [B, S, d] -> q, k (scaled by Dh^-½), v [B, S, H, Dh] and the input
    gate's preactivation and the log forget gate [B, S, H], all fp32."""
    q = torch.einsum("bsd,dhk->bshk", x, cell.wq).float()
    k = torch.einsum("bsd,dhk->bshk", x, cell.wk).float()
    k = k * (k.shape[-1] ** -0.5)
    v = torch.einsum("bsd,dhk->bshk", x, cell.wv).float()
    x32 = x.float()
    i_raw = x32 @ cell.w_i
    log_f = F.logsigmoid(x32 @ cell.w_f + cell.f_bias)
    return q, k, v, i_raw, log_f


def mlstm_init_state_raw(b: int, h: int, dh: int, device="cuda"):
    return (torch.zeros((b, h, dh, dh), dtype=F32, device=device),
            torch.zeros((b, h, dh), dtype=F32, device=device),
            torch.full((b, h), -1e30, dtype=F32, device=device))


def _mlstm_step(state, qt, kt, vt, it, lft):
    """One step of the exact recurrence: [B, H, Dh] / [B, H] inputs.
    Returns (y [B, H, Dh], new state)."""
    c, n, m = state
    m_new = torch.maximum(lft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(lft + m - m_new)
    c = (f_p[..., None, None] * c
         + i_p[..., None, None] * (vt[..., :, None] * kt[..., None, :]))
    n = f_p[..., None] * n + i_p[..., None] * kt
    num = torch.einsum("bhij,bhj->bhi", c, qt)
    den = torch.einsum("bhj,bhj->bh", n, qt).abs()
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return y, (c, n, m_new)


def mlstm_sequential(cell: MLSTMCell, x):
    """The oracle: the exact recurrence, step by step. [B, S, d] ->
    [B, S, H·Dh] (fp32)."""
    q, k, v, i_raw, log_f = _mlstm_qkvif(cell, x)
    b, s, h, dh = q.shape
    def step(state, t):
        y, state = _mlstm_step(state, q[:, t], k[:, t], v[:, t],
                               i_raw[:, t], log_f[:, t])
        return state, y

    _, ys = scan(step, mlstm_init_state_raw(b, h, dh, x.device), s)
    return torch.stack(ys, 1).reshape(b, s, h * dh)


def _mlstm_chunk(carry, xs):
    """One chunk of the chunkwise-parallel mLSTM. carry: (C, n, m); xs:
    q, k, v [B, c, H, Dh], i_raw, log_f [B, c, H]."""
    c_in, n_in, m_in = carry
    q, k, v, i_raw, log_f = xs
    c_len = q.shape[1]
    f_cum = torch.cumsum(log_f, dim=1)  # inclusive cumulative log forget
    # stabiliser m_t = F_t + max(m_in, cummax_{s<=t}(i_s - F_s))
    i_shift = i_raw - f_cum
    run_max = torch.cummax(i_shift, dim=1).values
    m_t = f_cum + torch.maximum(m_in[:, None], run_max)  # [B, c, H]
    # intra-chunk weights exp(i_s + F_t - F_s - m_t), s <= t: [B, t, s, H]
    logw = i_shift[:, None] + f_cum[:, :, None] - m_t[:, :, None]
    causal = torch.ones((c_len, c_len), dtype=torch.bool,
                        device=q.device).tril()
    w = torch.where(causal[None, :, :, None], torch.exp(logw), 0.0)
    scores = torch.einsum("bthk,bshk->btsh", q, k)
    inter = torch.einsum("btsh,btsh,bshk->bthk", scores, w, v)
    n_inter = torch.einsum("btsh,bshk->bthk", w, k)
    # the carried state's share, exp(m_in + F_t - m_t)·(C_in·q): C[i, j] =
    # v_i k_j, so y_i = sum_j C[i, j] q_j contracts C's second index
    decay0 = torch.exp(m_in[:, None] + f_cum - m_t)  # [B, c, H]
    qc = torch.einsum("bthk,bhjk->bthj", q, c_in)
    num = inter + decay0[..., None] * qc
    nq = torch.einsum("bthk,bhk->bth", q, n_in)
    den = (torch.einsum("bthk,bthk->bth", n_inter, q) + decay0 * nq).abs()
    y = num / torch.maximum(den, torch.exp(-m_t))[..., None]
    # the carry at the chunk's end
    m_end, f_total = m_t[:, -1], f_cum[:, -1]  # [B, H]
    wc = torch.exp(i_shift + f_total[:, None] - m_end[:, None])  # [B, c, H]
    scale = torch.exp(m_in + f_total - m_end)
    c_new = scale[..., None, None] * c_in + torch.einsum(
        "bsh,bshi,bshj->bhij", wc, v, k)
    n_new = scale[..., None] * n_in + torch.einsum("bsh,bshk->bhk", wc, k)
    return (c_new, n_new, m_end), y


def mlstm_chunked(cell: MLSTMCell, x, *, chunk: int = 128, state=None):
    """Chunkwise-parallel mLSTM. [B, S, d] -> ([B, S, H·Dh] fp32, final
    state). The sequence is padded to a multiple of the chunk with zero
    q, k, v, input gate and log forget gate, as the JAX package pads it:
    the pad moves the carried stabiliser m, so the carried state is the
    JAX package's, not the unpadded recurrence's."""
    q, k, v, i_raw, log_f = _mlstm_qkvif(cell, x)
    b, s, h, dh = q.shape
    if state is None:
        state = mlstm_init_state_raw(b, h, dh, x.device)
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw, log_f = (F.pad(t, (0, 0, 0, pad)) for t in (i_raw, log_f))
    def step(state, j):
        lo = j * chunk
        return _mlstm_chunk(state, tuple(
            t[:, lo:lo + chunk] for t in (q, k, v, i_raw, log_f)))

    state, ys = scan(step, state, (s + pad) // chunk)
    return torch.cat(ys, 1)[:, :s].reshape(b, s, h * dh), state


def mlstm_decode_step(cell: MLSTMCell, state, x_t):
    """x_t [B, d]. Returns (y [B, H·Dh] in x_t's dtype, new state)."""
    q, k, v, i_raw, log_f = _mlstm_qkvif(cell, x_t[:, None])
    y, state = _mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                           log_f[:, 0])
    return y.reshape(y.shape[0], -1).to(x_t.dtype), state


# ===========================================================================
# sLSTM (scalar cell, exponential gating, per-head recurrence). State:
# {h, c, n, m} each [B, H, Dh].
# ===========================================================================

GATES = ("z", "i", "f", "o")


class SLSTMCell(nn.Module):
    """Input weights wz / wi / wf / wo [d, H, Dh], recurrent rz / ri / rf /
    ro [H, Dh, Dh] and f_bias [H, Dh] in fp32; out_proj [H·Dh, d] in the
    model's dtype."""

    def __init__(self, d_model: int, n_heads: int, d_head: int, dtype,
                 device):
        super().__init__()
        for g in GATES:
            setattr(self, "w" + g,
                    _param((d_model, n_heads, d_head), F32, device))
        for g in GATES:
            setattr(self, "r" + g,
                    _param((n_heads, d_head, d_head), F32, device))
        self.f_bias = _param((n_heads, d_head), F32, device)
        self.out_proj = _param((n_heads * d_head, d_model), dtype, device)

    def init_(self, generator) -> None:
        for g in GATES:
            dense_init(getattr(self, "w" + g), generator)
        for g in GATES:  # fan-in on the input head dim
            dense_init(getattr(self, "r" + g), generator, in_axis=1)
        self.f_bias.fill_(3.0)
        dense_init(self.out_proj, generator)


def slstm_init_state(batch: int, n_heads: int, d_head: int,
                     device="cuda") -> dict:
    z = torch.zeros((batch, n_heads, d_head), dtype=F32, device=device)
    return {"h": z, "c": z, "n": z + 1e-6, "m": z - 1e30}


def _slstm_step(cell: SLSTMCell, state: dict, x_t: dict) -> dict:
    """One recurrence step; x_t holds the four gates' projected inputs
    [B, H, Dh]."""
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]

    def rec(g):
        return x_t[g] + torch.einsum("bhk,hkj->bhj", h, getattr(cell, "r" + g))

    z = torch.tanh(rec("z"))
    i_raw = rec("i")
    f_raw = rec("f") + cell.f_bias
    o = torch.sigmoid(rec("o"))
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def slstm_apply(cell: SLSTMCell, x, *, state=None):
    """x [B, S, d] -> ([B, S, d], final state), step by step over S."""
    b, s, _ = x.shape
    h_, dh = cell.f_bias.shape
    if state is None:
        state = slstm_init_state(b, h_, dh, x.device)
    x32 = x.float()
    proj = {g: torch.einsum("bsd,dhk->bshk", x32, getattr(cell, "w" + g))
            for g in GATES}
    def step(state, t):
        state = _slstm_step(cell, state, {g: p[:, t] for g, p in proj.items()})
        return state, state["h"]

    state, hs = scan(step, state, s)
    y = torch.stack(hs, 1).reshape(b, s, h_ * dh)
    return y.to(x.dtype) @ cell.out_proj, state


def slstm_decode_step(cell: SLSTMCell, state: dict, x_t):
    """x_t [B, d]. Returns (y [B, d], new state)."""
    x32 = x_t.float()
    proj = {g: torch.einsum("bd,dhk->bhk", x32, getattr(cell, "w" + g))
            for g in GATES}
    state = _slstm_step(cell, state, proj)
    y = state["h"].reshape(x_t.shape[0], -1)
    return y.to(x_t.dtype) @ cell.out_proj, state
