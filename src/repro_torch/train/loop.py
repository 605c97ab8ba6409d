"""Step functions. Only the serve step is ported yet; the training step
and its optimizer are ROADMAP.md queue 1 item 8."""

from __future__ import annotations

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """One batched decode step: (params, cache, tokens, index) -> (logits,
    cache). The cache is updated in place."""

    def serve_step(params, cache, tokens, cache_index):
        return T.decode(params, cfg, cache, tokens, cache_index)

    return serve_step
