"""xLSTM LM (xlstm-125m): interleaved mLSTM (matrix memory) and sLSTM
blocks (the counterpart of ``repro.models.xlstm``).

Every ``cfg.slstm_every``-th layer is an sLSTM block, the rest mLSTM.
mLSTM blocks use the xLSTM paper's pre-up-projection (pf = 2); sLSTM
blocks a post gated FFN. The blocks are an ``nn.ModuleList`` of the two
kinds (the JAX package's plain list). Serving state is O(1) in the
context: a recurrent state per layer, no KV cache. Positions play no
part. ``loss_fn`` is the next-token cross-entropy; with grad mode on each
block is recomputed in the backward, as the JAX package's
``jax.checkpoint`` of each block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models import ssm


def layer_kinds(cfg: ModelConfig) -> tuple[str, ...]:
    k = cfg.slstm_every
    return tuple("slstm" if (k and (i + 1) % k == 0) else "mlstm"
                 for i in range(cfg.n_layers))


def slstm_ffn_width(d: int) -> int:
    return int(d * 4 / 3 / 64) * 64 or d


class MLSTMBlock(nn.Module):
    """ln, up [d, 4d] (x_in and gate), cell (an mLSTM over 2d), down
    [2d, d]."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dt = cfg.d_model, C.param_dtype(cfg)
        d_in = 2 * d  # pf = 2 up-projection
        self.ln = C.RMSNorm(d, device)
        self.up = C._param((d, 2 * d_in), dt, device)
        self.cell = ssm.MLSTMCell(d_in, cfg.n_heads, d_in // cfg.n_heads, dt,
                                  device)
        self.down = C._param((d_in, d), dt, device)

    def init_(self, generator) -> None:
        self.ln.init_()
        C.dense_init(self.up, generator)
        self.cell.init_(generator)
        C.dense_init(self.down, generator)


class SLSTMBlock(nn.Module):
    """ln, cell (an sLSTM over d), ln2, and a SwiGLU FFN ffn_gate / ffn_up
    [d, f], ffn_down [f, d]."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, dt = cfg.d_model, C.param_dtype(cfg)
        d_ff = slstm_ffn_width(d)
        self.ln = C.RMSNorm(d, device)
        self.cell = ssm.SLSTMCell(d, cfg.n_heads, d // cfg.n_heads, dt, device)
        self.ln2 = C.RMSNorm(d, device)
        self.ffn_gate = C._param((d, d_ff), dt, device)
        self.ffn_up = C._param((d, d_ff), dt, device)
        self.ffn_down = C._param((d_ff, d), dt, device)

    def init_(self, generator) -> None:
        self.ln.init_()
        self.cell.init_(generator)
        self.ln2.init_()
        # the JAX package draws ffn_gate and ffn_up from one key: equal
        C.dense_init(self.ffn_gate, generator)
        self.ffn_up.copy_(self.ffn_gate)
        C.dense_init(self.ffn_down, generator)


BLOCKS = {"mlstm": MLSTMBlock, "slstm": SLSTMBlock}


class XLSTM(nn.Module):
    """embedding, blocks (mLSTM and sLSTM, ``layer_kinds``), final_norm."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embedding = C.Embedding(cfg, device)
        self.blocks = nn.ModuleList(BLOCKS[kind](cfg, device)
                                    for kind in layer_kinds(cfg))
        self.final_norm = C.RMSNorm(cfg.d_model, device)

    def init_(self, generator) -> None:
        self.embedding.init_(generator)
        for block in self.blocks:
            block.init_(generator)
        self.final_norm.init_()


def init_params(generator: torch.Generator, cfg: ModelConfig) -> XLSTM:
    """Random weights on the generator's device, in ``cfg.dtype`` (the
    recurrences' gates and weights in fp32)."""
    params = XLSTM(cfg, generator.device)
    params.init_(generator)
    return params


def _norm(norm, x, cfg: ModelConfig):
    return C.rmsnorm_apply(norm, x, cfg.norm_eps)


def _mlstm_block(block: MLSTMBlock, x, cfg: ModelConfig, state=None):
    x_in, gate = (_norm(block.ln, x, cfg) @ block.up).chunk(2, dim=-1)
    y, new_state = ssm.mlstm_chunked(block.cell, x_in, state=state)
    y = y.to(x.dtype) * F.silu(gate)
    return x + y @ block.down, new_state


def _mlstm_block_decode(block: MLSTMBlock, x_t, state, cfg: ModelConfig):
    x_in, gate = (_norm(block.ln, x_t, cfg) @ block.up).chunk(2, dim=-1)
    y, new_state = ssm.mlstm_decode_step(block.cell, state, x_in)
    return x_t + (y * F.silu(gate)) @ block.down, new_state


def _slstm_ffn(block: SLSTMBlock, x, cfg: ModelConfig):
    h2 = _norm(block.ln2, x, cfg)
    ff = F.silu(h2 @ block.ffn_gate) * (h2 @ block.ffn_up)
    return x + ff @ block.ffn_down


def _slstm_block(block: SLSTMBlock, x, cfg: ModelConfig, state=None):
    y, new_state = ssm.slstm_apply(block.cell, _norm(block.ln, x, cfg),
                                   state=state)
    return _slstm_ffn(block, x + y, cfg), new_state


def _slstm_block_decode(block: SLSTMBlock, x_t, state, cfg: ModelConfig):
    y, new_state = ssm.slstm_decode_step(block.cell, state,
                                         _norm(block.ln, x_t, cfg))
    return _slstm_ffn(block, x_t + y, cfg), new_state


def forward_hidden(params: XLSTM, tokens, cfg: ModelConfig):
    """Final hidden states [B, S, d] from a fresh state; under autograd
    each block is recomputed in the backward (``common.remat_call``)."""
    x = C.embed_tokens(params.embedding, tokens)
    for kind, block in zip(layer_kinds(cfg), params.blocks):
        fn = _mlstm_block if kind == "mlstm" else _slstm_block
        x, _ = C.remat_call(fn, block, x, cfg)
    return _norm(params.final_norm, x, cfg)


def loss_fn(params: XLSTM, batch: dict, cfg: ModelConfig):
    """Next-token cross-entropy (``repro.models.xlstm.loss_fn``). batch:
    tokens [B, S], labels [B, S]."""
    x = forward_hidden(params, batch["tokens"], cfg)
    return C.chunked_xent_loss(params.embedding, x, batch["labels"])


# -- serving: a recurrent state instead of a KV cache ---------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device="cuda") -> dict:
    """{"states": one per layer: {"mlstm": (C, n, m)} or {"slstm": {h, c,
    n, m}}}; O(1) in ``seq_len``."""
    del seq_len
    states = []
    for kind in layer_kinds(cfg):
        if kind == "mlstm":
            d_in = 2 * cfg.d_model
            states.append({"mlstm": ssm.mlstm_init_state_raw(
                batch, cfg.n_heads, d_in // cfg.n_heads, device)})
        else:
            states.append({"slstm": ssm.slstm_init_state(
                batch, cfg.n_heads, cfg.d_model // cfg.n_heads, device)})
    return {"states": states}


def prefill(params: XLSTM, tokens, cfg: ModelConfig):
    """Prompt pass that keeps each layer's state after the prompt. Returns
    (last-token logits [B, V] fp32, cache)."""
    x = C.embed_tokens(params.embedding, tokens)
    states = []
    for kind, block in zip(layer_kinds(cfg), params.blocks):
        fn = _mlstm_block if kind == "mlstm" else _slstm_block
        x, st = fn(block, x, cfg)
        states.append({kind: st})
    x = _norm(params.final_norm, x, cfg)
    return C.logits_last(params.embedding, x[:, -1]), {"states": states}


def decode_step(params: XLSTM, cache: dict, tokens, pos, cfg: ModelConfig):
    """One token a sequence (tokens [B]; ``pos`` unused: the recurrence is
    position-free). Returns (logits [B, V] fp32, a new cache)."""
    del pos
    x = C.embed_tokens(params.embedding, tokens)
    new_states = []
    for kind, block, st in zip(layer_kinds(cfg), params.blocks,
                               cache["states"]):
        fn = _mlstm_block_decode if kind == "mlstm" else _slstm_block_decode
        x, new = fn(block, x, st[kind], cfg)
        new_states.append({kind: new})
    x = _norm(params.final_norm, x, cfg)
    return C.logits_last(params.embedding, x), {"states": new_states}
