"""Shared model building blocks: initializers, RMSNorm, LayerNorm, RoPE,
MLPs, embeddings and the chunked cross-entropy loss (the counterpart of
``repro.models.common``).

Each parameter block is an ``nn.Module`` (a container: the functions below
apply it) whose tensors keep the JAX package's names and layouts
(``wi_gate [d, d_ff]``, ``embed [V, d]``, …), so ``repro_torch.convert``
can carry a JAX parameter tree across leaf for leaf. Modules are built
empty on a device; ``init_(generator)`` fills them from an explicit
``torch.Generator`` (its device is the modules' device). Parameters are
built with ``requires_grad=False``, as serving wants them;
``train.train_loop.init_state`` turns the gradient on for training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import opcount


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _needs_grad(a) -> bool:
    if isinstance(a, nn.Module):
        return any(p.requires_grad for p in a.parameters())
    return isinstance(a, torch.Tensor) and a.requires_grad


def scan(body, carry, n: int):
    """(carry, [y_0, ..., y_{n-1}]) of ``carry, y_i = body(carry, i)`` for
    i in range(n): a recurrence's loop (``lax.scan``'s counterpart).

    On CUDA and the CPU it loops. Under an op counter
    (``utils.opcount``) on the meta device it runs step 0, then step 1
    once with its counts, and its backward's, multiplied by n - 1, as
    ``repro.utils.hlo`` multiplies a ``while`` body by its trip count:
    step 1 stands for every later step (its carry comes out of a step, as
    theirs does, so its backward is theirs), and every later y_i is its
    y."""
    if n > 2 and opcount.active() is not None and any(
            t.is_meta for t in tree_leaves(carry)
            if isinstance(t, torch.Tensor)):
        carry, y0 = body(carry, 0)
        with opcount.repeat(n - 1) as loop:
            carry, y = body(carry, 1)
            loop.finish(carry, y)
        return carry, [y0] + [y] * (n - 1)
    ys = []
    for i in range(n):
        carry, y = body(carry, i)
        ys.append(y)
    return carry, ys


def remat_call(fn, *args):
    """``fn(*args)``; with grad mode on and something among the arguments
    (a tensor, or a module's parameters) requiring a gradient, its
    activations are not kept but recomputed in the backward
    (``jax.checkpoint``'s counterpart). Otherwise (serving) a plain
    call."""
    if torch.is_grad_enabled() and any(map(_needs_grad, args)):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# -- initializers -------------------------------------------------------------

def dense_init(t: torch.Tensor, generator, in_axis: int = 0) -> None:
    """In place: truncated normal at ±2σ with σ = fan_in^-½ (maxtext
    style, as ``repro.models.common.dense_init``). An empty tensor (an
    MLP with d_ff = 0) has nothing to draw."""
    if t.numel() == 0:
        return
    w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.copy_(w * t.shape[in_axis] ** -0.5)


def embed_init(t: torch.Tensor, generator) -> None:
    """In place: normal × 0.02."""
    w = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    w.normal_(generator=generator)
    t.copy_(w * 0.02)


# -- norms --------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = _param((d,), torch.float32, device)

    def init_(self, generator=None) -> None:
        self.scale.fill_(1.0)


def rmsnorm_init(d: int, device) -> RMSNorm:
    norm = RMSNorm(d, device)
    norm.init_()
    return norm


def rmsnorm_apply(norm: RMSNorm, x: torch.Tensor, eps: float = 1e-5):
    """fp32 inside; returns x's dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * norm.scale).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = _param((d,), torch.float32, device)
        self.bias = _param((d,), torch.float32, device)

    def init_(self, generator=None) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()


def layernorm_init(d: int, device) -> LayerNorm:
    norm = LayerNorm(d, device)
    norm.init_()
    return norm


def layernorm_apply(norm: LayerNorm, x: torch.Tensor, eps: float = 1e-5):
    """fp32 inside (the population variance); returns x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * norm.scale + norm.bias).to(x.dtype)


# -- RoPE ---------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (
        torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
        / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, d_head]; positions: [..., seq] (int). The
    split-halves form: (x1, x2) → (x1·cos − x2·sin, x2·cos + x1·sin)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = (positions[..., None].float() * freqs)[..., None, :]
    sin, cos = angles.sin(), angles.cos()
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP (dense): SwiGLU or GELU ----------------------------------------------

class MLP(nn.Module):
    """SwiGLU for ``mlp_type == "swiglu"``; every other type, "none"
    included, is the GELU MLP, as in the JAX package's ``mlp_init``."""

    def __init__(self, cfg: ModelConfig, device, d_ff: int | None = None):
        super().__init__()
        d, d_ff = cfg.d_model, d_ff or cfg.d_ff
        dt = param_dtype(cfg)
        self.swiglu = cfg.mlp_type == "swiglu"
        if self.swiglu:
            self.wi_gate = _param((d, d_ff), dt, device)
            self.wi_up = _param((d, d_ff), dt, device)
        else:
            self.wi = _param((d, d_ff), dt, device)
        self.wo = _param((d_ff, d), dt, device)

    def init_(self, generator) -> None:
        for t in self.parameters():
            dense_init(t, generator)


def mlp_init(cfg: ModelConfig, generator, d_ff: int | None = None) -> MLP:
    mlp = MLP(cfg, generator.device, d_ff)
    mlp.init_(generator)
    return mlp


def mlp_apply(mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """x: [batch, seq, d_model] -> same."""
    if mlp.swiglu:
        h = F.silu(x @ mlp.wi_gate) * (x @ mlp.wi_up)
    else:
        h = F.gelu(x @ mlp.wi, approximate="tanh")
    return h @ mlp.wo


# -- embedding / unembedding ----------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = param_dtype(cfg)
        self.embed = _param((cfg.vocab, cfg.d_model), dt, device)
        self.unembed = (None if cfg.tie_embeddings else
                        _param((cfg.d_model, cfg.vocab), dt, device))

    def init_(self, generator) -> None:
        embed_init(self.embed, generator)
        if self.unembed is not None:
            dense_init(self.unembed, generator)


def embedding_init(cfg: ModelConfig, generator) -> Embedding:
    emb = Embedding(cfg, generator.device)
    emb.init_(generator)
    return emb


def embed_tokens(emb: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), emb.embed)


def unembed_matrix(emb: Embedding) -> torch.Tensor:
    return emb.embed.T if emb.unembed is None else emb.unembed


def logits_last(emb: Embedding, x_last: torch.Tensor) -> torch.Tensor:
    """Decode-path logits for the final position only, in fp32.
    x_last: [B, d] -> [B, V]."""
    return x_last.float() @ unembed_matrix(emb).float()


def chunked_xent_loss(emb: Embedding, x: torch.Tensor, labels: torch.Tensor,
                      *, chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy over the labels >= 0, computed in
    chunks of ``min(chunk, S)`` along the sequence so the full [B, S, V]
    logits never exist at once (``repro.models.common.chunked_xent_loss``).

    x [B, S, d] final hidden states; labels [B, S] int targets, -1 where no
    loss is taken. The tail is padded with -1 labels; each chunk's logits
    are fp32 against ``unembed_matrix``; the chunk sums are added in order
    and divided by the number of valid labels (1 at least)."""
    w = unembed_matrix(emb).float()
    b, s, d = x.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int32, device=x.device)
    for lo in range(0, s + pad, chunk):
        logits = x[:, lo:lo + chunk].float() @ w  # [B, c, V]
        lc = labels[:, lo:lo + chunk].long()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, lc.clamp(min=0)[..., None])[..., 0]
        valid = lc >= 0
        total = total + torch.where(valid, lse - picked, 0.0).sum()
        count = count + valid.sum(dtype=torch.int32)
    return total / count.clamp(min=1)
