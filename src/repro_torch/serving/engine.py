"""Serving engine: continuous batching over the Wolf-KV paged cache (the
counterpart of ``repro.serving.engine``).

Request model:
  * ``policy="append"``  — standard decode; blocks die only when the request
    finishes (cold churn).
  * ``policy="h2o:R"``   — heavy-hitter-style eviction: every new token
    evicts one of the oldest R% cache entries at random (hot churn — the
    serving analogue of the paper's hot pages).
  * ``policy="window:W"``— sliding-window: tokens beyond W evicted in order
    (prefix pages die whole — cheap reclamation).

Each policy class is a Wolf-KV temperature group. One engine step admits
(prefill), decodes one token per running sequence (the paged-attention
kernel), evicts, and runs the manager's compaction moves (the gc_compact
kernel). The host control plane is the JAX package's, decision for
decision: eviction draws from ``np.random.default_rng(seed)`` as there, so
the port's engine and the JAX package's give the same move lists. The
model is a transformer over the config whatever its family (xLSTM, Hymba
and Whisper configs included), as the JAX package's engine builds it; its
random weights come from a ``torch.Generator`` on the engine's device.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kvcache.manager import WolfKVManager
from repro_torch.models.transformer import init_params
from repro_torch.serving.paged_model import (
    apply_moves,
    init_pools,
    paged_decode_step,
    paged_prefill,
)

POLICIES = ("append", "h2o", "window")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # int32 tokens
    max_new: int
    policy: str = "append"  # append | h2o:<rate%> | window:<W>
    out: list = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def policy_kind(self) -> str:
        return self.policy.split(":")[0]

    @property
    def policy_arg(self) -> int:
        parts = self.policy.split(":")
        return int(parts[1]) if len(parts) > 1 else 0


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        n_blocks: int = 256,
        page: int = 16,
        max_pages_per_seq: int = 32,
        max_batch: int = 8,
        groups: tuple[str, ...] = ("append", "h2o", "window"),
        adaptive: bool = True,
        seed: int = 0,
        device="cuda",
    ):
        self.cfg = cfg
        self.page = page
        self.max_pages = max_pages_per_seq
        self.max_batch = max_batch
        self.device = torch.device(device)
        self.group_of_policy = {k: i for i, k in enumerate(groups)}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(gen, cfg)
        self.pools = init_pools(cfg, n_blocks, page, self.device)
        self.manager = WolfKVManager(
            n_blocks, page, len(groups), adaptive=adaptive
        )
        self.queue: deque[Request] = deque()
        self.running: list[Request] = []
        self.rng = np.random.default_rng(seed)
        self.steps = 0
        self._moved: list[list] = []  # non-empty move lists since the last step

    def _apply_moves(self):
        moves = self.manager.drain_moves()
        if moves:
            self._moved.append(moves)
        self.pools = apply_moves(self.pools, moves)

    def _dev(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def admit(self) -> int:
        """Prefill queued requests while the batch has room; ``step`` does
        this first. Returns the number admitted."""
        n = 0
        while self.queue and len(self.running) < self.max_batch:
            req = self.queue.popleft()
            g = self.group_of_policy[req.policy_kind]
            self.manager.add_sequence(req.rid, g)
            # prefill: reserve slots for every prompt token, then one pass
            wb = np.zeros(len(req.prompt), np.int32)
            ws = np.zeros(len(req.prompt), np.int32)
            for i in range(len(req.prompt)):
                wb[i], ws[i] = self.manager.append_token(req.rid)
            self._apply_moves()
            logits, self.pools = paged_prefill(
                self.params, self.cfg, self.pools,
                self._dev(np.asarray(req.prompt, np.int32)[None]),
                self._dev(wb[None]), self._dev(ws[None]),
            )
            req.out.append(int(logits[0].argmax()))
            self.running.append(req)
            n += 1
        return n

    def _evict(self, req: Request):
        mgr, sid = self.manager, req.rid
        seq = mgr.seqs[sid]
        if req.policy_kind == "window":
            w = max(req.policy_arg, self.page)
            # evict everything below cache_len - w
            hi = seq.cache_len - w
            for ci in range(hi):
                if ci < len(seq.valid) and seq.valid[ci]:
                    mgr.evict_token(sid, ci)
        elif req.policy_kind == "h2o":
            rate = req.policy_arg or 50
            # one-in, one-out beyond a warmup, from the oldest `rate`% alive
            alive = np.flatnonzero(seq.valid[: seq.cache_len])
            if len(alive) > 4 * self.page:
                k = max(1, int(len(alive) * rate / 100))
                victim = int(self.rng.choice(alive[:k]))
                mgr.evict_token(sid, victim)

    def step(self) -> dict:
        """One engine iteration: admit, decode one token each, evict, GC.
        Returns the batch's decode logits [B, V] and the non-empty move lists
        applied since the last step (admissions included), in order."""
        self.admit()
        if not self.running:
            moved, self._moved = self._moved, []
            return {"running": 0, "wa": self.manager.write_amplification,
                    "logits": None, "move_lists": moved}
        b = len(self.running)
        tokens = np.zeros(b, np.int32)
        wb = np.zeros(b, np.int32)
        ws = np.zeros(b, np.int32)
        pos = np.zeros(b, np.int32)
        for i, req in enumerate(self.running):
            tokens[i] = req.out[-1]
            pos[i] = self.manager.cache_len(req.rid)
            wb[i], ws[i] = self.manager.append_token(req.rid)
        self._apply_moves()
        tables = np.stack(
            [self.manager.block_table(r.rid, self.max_pages) for r in self.running]
        )
        valid = np.stack(
            [self.manager.slot_valid(r.rid, self.max_pages) for r in self.running]
        )
        lengths = np.asarray(
            [self.manager.cache_len(r.rid) for r in self.running], np.int32
        )
        logits, self.pools = paged_decode_step(
            self.params, self.cfg, self.pools,
            self._dev(tables), self._dev(valid.astype(np.int8)),
            self._dev(lengths), self._dev(wb), self._dev(ws),
            self._dev(tokens), self._dev(pos),
        )
        nxt = logits.argmax(-1).cpu().numpy()
        still = []
        for i, req in enumerate(self.running):
            req.out.append(int(nxt[i]))
            self._evict(req)
            if len(req.out) >= req.max_new:
                req.done = True
                self.manager.finish_sequence(req.rid)
            else:
                still.append(req)
        self.running = still
        self._apply_moves()
        self.steps += 1
        moved, self._moved = self._moved, []
        return {
            "running": len(self.running),
            "wa": self.manager.write_amplification,
            "free_blocks": len(self.manager.free),
            "logits": logits,
            "move_lists": moved,
        }

    def run_until_drained(self, max_steps: int = 10_000) -> dict:
        for _ in range(max_steps):
            self.step()
            if not self.running and not self.queue:
                break
        return {
            "steps": self.steps,
            "wa": self.manager.write_amplification,
            "appended": self.manager.appended,
            "copied": self.manager.copied,
        }
