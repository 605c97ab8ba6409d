"""Step functions: training (with grad accumulation and optional gradient
compression), prefill and decode/serve.

Twin of ``repro/train/loop.py``, in eager PyTorch. The state is a
:class:`TrainState` whose parameters are the model module (trainable)
and whose optimizer leaves are dicts of tensors by parameter name."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import resolve_device, tracing
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import wide
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import compression, sharding


@dataclasses.dataclass
class TrainState:
    """``params``: the model (its parameters require grad); ``opt_state``:
    ``{"m": {name: t}, "v": {name: t}, "count": int32 0-d}``; ``step``: an
    int32 0-d tensor; ``ef_state``: error-feedback residuals by name
    (compression), or None."""
    params: T.TransformerLM
    opt_state: dict
    step: torch.Tensor
    ef_state: dict | None = None

    def named(self) -> dict[str, torch.Tensor]:
        """The parameters by name, detached (they share storage)."""
        return {k: p.detach() for k, p in self.params.named_parameters()}

    def to(self, device, *, copy: bool = False) -> "TrainState":
        """A new state on ``device``; this one is left as it is. Tensors
        already there are shared unless ``copy`` is set."""
        move = (lambda t: t.to(device, copy=True)) if copy else (
            lambda t: t.to(device))
        tree = lambda d: None if d is None else {k: move(t)
                                                 for k, t in d.items()}
        params = T.from_named(self.params.cfg, tree(self.named()))
        return TrainState(
            params.requires_grad_(True),
            {"m": tree(self.opt_state["m"]), "v": tree(self.opt_state["v"]),
             "count": move(self.opt_state["count"])},
            move(self.step), tree(self.ef_state))

    def clone(self) -> "TrainState":
        """A deep copy on the same device."""
        return self.to(self.step.device, copy=True)


def init_state(cfg: ModelConfig, opt: AdamWConfig,
               generator: torch.Generator | None,
               device: str | torch.device | None = None,
               compress: bool = False) -> TrainState:
    """Random weights (``init_params``, on ``device``: ``cuda`` unless
    named), made trainable, zero moments and step 0; with ``compress`` a
    zero float32 error-feedback residual per parameter."""
    dev = resolve_device(device)
    params = T.init_params(cfg, generator, dev).requires_grad_(True)
    named = {k: p.detach() for k, p in params.named_parameters()}
    ef = ({k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
           for k, p in named.items()} if compress else None)
    return TrainState(params, adamw_init(named, opt),
                      torch.zeros((), dtype=torch.int32, device=dev), ef)


def stacked_leaf(cfg: ModelConfig, name: str) -> str:
    """The reference's leaf that holds the port's parameter ``name``:
    ``blocks.<l>.<p>`` is a slice of ``units/b{l % P}/<p>`` (``P`` the
    unit period); every other name is a leaf of its own."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return name
    return f"units/b{int(parts[1]) % len(T.unit_spec(cfg))}/{parts[2]}"


def loss_fn(params: T.TransformerLM, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy over the labels >= 0 (f32
    log-softmax) plus the MoE aux loss. Returns (total, metrics) with
    metrics ``loss``, ``ce``, ``aux`` and ``tokens``, detached."""
    logits, aux = T.forward(params, cfg, batch)
    labels = batch["labels"].to(logits.device)
    if logits.shape[1] != labels.shape[1]:   # vision prefix already included
        raise ValueError("labels must cover the full (patch+text) sequence")
    valid = labels >= 0
    lab = torch.where(valid, labels, 0).long()
    if sharding.is_dtensor(logits):
        nll = _nll_on_shards(logits, lab)
    else:
        logp = torch.log_softmax(wide(logits), dim=-1)
        nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    denom = torch.clamp(valid.sum(), min=1)
    ce = torch.where(valid, nll, 0.0).sum() / denom
    total = ce + aux
    return total, {"loss": total.detach(), "ce": ce.detach(),
                   "aux": aux.detach(), "tokens": denom.float()}


def _nll_on_shards(logits: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """The per-token ``-log softmax(logits)[lab]`` of ``DTensor`` logits
    (B, S, V), on each rank's own shards: its batch rows, and where the
    vocab is split its vocab slice, whose log-sum-exp and target logit
    join the other slices' by an all-reduce of (B, S) values (Megatron's
    vocab-parallel cross entropy). Gathering the vocab, or differentiating
    ``gather`` on a ``DTensor``, would hold the whole logits on a rank.
    With the vocab whole on the rank it is the unsharded arithmetic."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = logits.device_mesh
    place = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2)
             else Replicate() for p in logits.placements]
    if tuple(logits.placements) != tuple(place):
        logits = logits.redistribute(mesh, place)
    rows = [p if p.is_shard(0) else Replicate() for p in place]
    lab = (lab.redistribute(mesh, rows).to_local() if sharding.is_dtensor(lab)
           else sharding.local_chunk(lab, mesh, rows))[..., None]
    x = wide(sharding.to_local(logits))
    vocab = [i for i, p in enumerate(place) if p.is_shard(2)]
    if math.prod(mesh.size(i) for i in vocab) == 1:
        nll = -torch.gather(torch.log_softmax(x, dim=-1), -1, lab)[..., 0]
        return DTensor.from_local(nll, mesh, rows, run_check=False)

    def across(t, op):
        """(B, S) local values reduced over the vocab slices."""
        share = [Partial(op) if i in vocab else p for i, p in enumerate(rows)]
        return DTensor.from_local(t, mesh, share, run_check=False
                                  ).redistribute(mesh, rows).to_local()

    width = x.shape[-1]
    lo = sharding.shard_index(mesh, vocab) * width
    m = across(x.detach().amax(dim=-1, keepdim=True), "max")
    lse = torch.log(across(torch.exp(x - m).sum(-1, keepdim=True),
                           "sum")) + m
    mine = (lab >= lo) & (lab < lo + width)
    target = torch.where(mine, torch.gather(
        x, -1, torch.clamp(lab - lo, 0, width - 1)), 0.0)
    nll = (lse - across(target, "sum"))[..., 0]
    return DTensor.from_local(nll, mesh, rows, run_check=False)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *,
                    lr_fn: Callable | None = None, microbatches: int = 1,
                    compress_grads: bool = False, in_place: bool = False):
    """Returns ``step(state, batch) -> (state, metrics)``; ``batch`` holds
    tensors on the state's device.

    The contract: by default the step leaves the state it is given as it
    was and returns a new one (the reference's un-donated
    ``jax.jit(step)``), so one initial state can seed several runs. With
    ``in_place=True`` it writes the new parameters, moments, step and
    residuals into the given state's tensors and returns that same object
    (``jax.jit(step, donate_argnums=0)``): no second copy of the state is
    made, which a full-width model on one card needs.

    Gradients are taken with ``torch.autograd.grad`` (no ``.grad`` is
    written). ``microbatches > 1`` splits the batch on axis 0 and sums the
    gradients in float32, then divides; the metrics are the last
    microbatch's. Then compression (``compress_grads``: int8 with error
    feedback, one scale per stacked leaf of the reference's), then AdamW.
    The metrics gain ``grad_norm``, ``clip_scale`` and ``lr``."""

    def value_and_grads(params, batch):
        names, leaves = zip(*params.named_parameters())
        with torch.enable_grad():
            with tracing.span("train.forward"):
                total, metrics = loss_fn(params, cfg, batch)
            with tracing.span("train.backward"):
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # a parameter the batch does not reach (a front end the batch has
        # no input for) gets a zero gradient, as jax.grad gives it
        return metrics, {k: torch.zeros_like(p) if g is None else g
                         for k, p, g in zip(names, leaves, grads)}

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state.params
        if microbatches > 1:
            gsum, metrics = None, None
            for i in range(microbatches):
                mbatch = {k: v.reshape(microbatches, v.shape[0] //
                                       microbatches, *v.shape[1:])[i]
                          for k, v in batch.items()}
                metrics, g = value_and_grads(params, mbatch)
                if gsum is None:
                    gsum = {k: wide(t) for k, t in g.items()}
                else:
                    gsum = {k: gsum[k] + t for k, t in g.items()}
                del g
            grads = {k: g / microbatches for k, g in gsum.items()}
            del gsum
        else:
            metrics, grads = value_and_grads(params, batch)

        ef = state.ef_state
        if compress_grads:
            # one int8 scale per stacked reference leaf, as it quantizes
            grads, ef = compression.compress_tree(
                grads, ef, {k: stacked_leaf(cfg, k) for k in grads})

        lr = lr_fn(state.step) if lr_fn else opt.lr
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state.opt_state, state.named(), opt, lr,
            in_place=in_place)
        del grads
        metrics.update(opt_metrics)
        metrics["lr"] = torch.as_tensor(lr, dtype=torch.float32,
                                        device=state.step.device)
        if in_place:
            state.step.add_(1)
            if compress_grads:
                for k, t in state.ef_state.items():
                    t.copy_(ef[k])
            return state, metrics
        new = T.from_named(cfg, new_params).requires_grad_(True)
        return TrainState(new, new_opt, state.step + 1, ef), metrics

    return step


def make_prefill_step(cfg: ModelConfig, *, max_len: int):
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch, max_len=max_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One batched decode step: (params, cache, tokens, index) -> (logits,
    cache). The cache is updated in place."""

    def serve_step(params, cache, tokens, cache_index):
        return T.decode(params, cfg, cache, tokens, cache_index)

    return serve_step
