"""Continuous-batching serving engine with dense slots, in PyTorch.

Twin of ``repro/serve/engine.py``'s :class:`ServeEngine` (the paged
engine is ROADMAP.md queue 1 item 5): a fixed pool of ``max_slots``
cache slots, each reserving ``max_len`` worth of device memory. Requests
are admitted into free slots with a whole-prompt prefill at batch 1,
and every engine tick runs ONE batched decode step for all slots at
their own positions.

* Inactive slots decode garbage that the per-slot valid mask hides;
  their tokens are pinned to 0, and the next admission into the slot
  overwrites its whole row.
* Greedy sampling (argmax) keeps the engine deterministic; a sampler
  hook is provided.
* Where the JAX engine rebuilds its cache (donated), this one writes in
  place: the prefilled slot is copied into its row of the batched
  cache, and each decode step writes its K/V into the same tensors.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def kv_bytes_per_token(cfg: ModelConfig, dt: int | None = None) -> int:
    """Per-token attention-cache bytes across all layers (a copy of
    ``repro/core/costmodel.py::kv_bytes_per_token`` for the dense
    family, which the port's cost model will take over)."""
    if dt is None:
        dt = 2 if cfg.dtype == "bfloat16" else 4
    if cfg.use_mla:
        per_layer = (cfg.kv_lora_rank + cfg.qk_rope_dim) * dt
    else:
        per_layer = 2 * cfg.num_kv_heads * cfg.head_dim * dt
    return per_layer * cfg.layer_kinds().count("attn")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class ServeEngine:
    """Runs on the device of ``params`` (a :class:`T.TransformerLM`)."""

    def __init__(self, cfg: ModelConfig, params: T.TransformerLM, *,
                 max_slots: int, max_len: int,
                 sampler: Callable[[torch.Tensor], torch.Tensor] | None = None):
        if cfg.is_encoder:
            raise ValueError("encoder-only model has no decode path")
        self.cfg = cfg
        self.params = params
        self.device = params.embed.device
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = T.init_cache(cfg, max_slots, max_len, device=self.device)
        self.free: deque[int] = deque(range(max_slots))
        self.active: dict[int, Request] = {}       # slot -> request
        self.waiting: deque[Request] = deque()
        self.finished: list[Request] = []
        # per-slot position of the NEXT token to be written
        self.positions = np.zeros(max_slots, dtype=np.int32)
        self.last_tokens = np.zeros(max_slots, dtype=np.int32)
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self.steps = 0
        self.decoded_tokens = 0

    # -- queue management ---------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError("request exceeds max_len")
        self.waiting.append(req)

    def _admit(self) -> None:
        while self.waiting and self.free:
            req = self.waiting.popleft()
            slot = self.free.popleft()
            req.slot = slot
            toks = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                   device=self.device)
            logits, pcache = T.prefill(self.params, self.cfg,
                                       {"tokens": toks}, max_len=self.max_len)
            # copy the prefilled slot into its row of the batched cache
            # (axis 1 is the slot axis of every leaf), in place
            for name, leaf in self.cache.items():
                leaf[:, slot] = pcache[name][:, 0]
            tok = int(self.sampler(logits[0, -1]))
            req.generated.append(tok)
            self.last_tokens[slot] = tok
            self.positions[slot] = len(req.prompt)
            self.active[slot] = req
            self._maybe_finish(slot)

    def _maybe_finish(self, slot: int) -> None:
        req = self.active.get(slot)
        if req is not None and req.done:
            del self.active[slot]
            self.free.append(slot)
            self.finished.append(req)

    # -- the engine tick ------------------------------------------------------

    def step(self) -> int:
        """Admit + one batched decode step.  Returns #active slots."""
        self._admit()
        if not self.active:
            return 0
        toks = torch.as_tensor(self.last_tokens[:, None], dtype=torch.long,
                               device=self.device)
        idx = torch.as_tensor(self.positions, dtype=torch.long,
                              device=self.device)
        logits, self.cache = T.decode(self.params, self.cfg, self.cache,
                                      toks, idx)
        sampled = self.sampler(logits[:, 0]).cpu().numpy()
        for slot, req in list(self.active.items()):
            tok = int(sampled[slot])
            req.generated.append(tok)
            self.last_tokens[slot] = tok
            self.positions[slot] += 1
            self.decoded_tokens += 1
            self._maybe_finish(slot)
        self.steps += 1
        return len(self.active)

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        while (self.waiting or self.active) and self.steps < max_steps:
            self.step()
        return sorted(self.finished, key=lambda r: r.uid)

    def stats(self) -> dict:
        return {"steps": self.steps, "decoded_tokens": self.decoded_tokens,
                "finished": len(self.finished),
                "avg_batch_occupancy":
                    self.decoded_tokens / max(1, self.steps) / self.max_slots}

    def hbm_reserved_bytes(self) -> int:
        """Attention-cache memory the dense engine reserves, occupancy-blind."""
        return self.max_slots * self.max_len * kv_bytes_per_token(self.cfg)
