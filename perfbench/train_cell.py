"""A training cell: the program's in-place train step
(``repro_torch.train.loop.make_train_step(cfg, opt, in_place=True)``) on
token batches made from the seed, timed by the host clock, then judged.

Set-up builds one train state from the benchmark's weights and drives it
through the checked steps with the window's own call and feed, reading
the program's losses, its first gradient as AdamW got it (the first
moment after one step over ``1 - b1``) and the parameters' change after
``reference_steps`` steps (against the weights made again from the
seed). The same state then trains through the window: steps run until
``--seconds`` have passed, and the window is the time of those steps.
After the window the program's state is freed and the float32 reference
follows the first ``reference_steps`` steps, and the loss of the one
after, on the same weights and batches.
"""

from __future__ import annotations

import math
import time

import torch

from perfbench import devtrace, traffic, work
from perfbench import weights as W
from perfbench.judge import norms
from perfbench.manifest import Cell, port_config
from perfbench.reference import model as ref
from perfbench.reference.common import Precision, full_f32

#: steps profiled after the window
TRACE_STEPS = 2


def lr_at(t: dict, step: int) -> float:
    """The cosine schedule with linear warm-up, at optimizer step
    ``step`` (0 for the first)."""
    base, warm, total = t["lr"], t["warmup"], t["total_steps"]
    if step < warm:
        return base * step / max(1, warm)
    x = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return 0.5 * base * (1 + math.cos(math.pi * x))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def program(cell: Cell, seed: int, device):
    """(train state, step, readings of the checked steps)."""
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         cosine_schedule)
    from repro_torch.train.loop import TrainState, make_train_step
    t, cfg = cell.spec["train"], cell.config
    pcfg = port_config(cfg)
    params = T.from_named(pcfg, W.make(cfg, seed, device)).requires_grad_(True)
    opt = AdamWConfig(lr=t["lr"], b1=t["b1"], b2=t["b2"], eps=t["eps"],
                      weight_decay=t["weight_decay"],
                      clip_norm=t["clip_norm"], moment_dtype=t["moment_dtype"])
    named = {k: p.detach() for k, p in params.named_parameters()}
    state = TrainState(params, adamw_init(named, opt),
                       torch.zeros((), dtype=torch.int32, device=device))
    step = make_train_step(pcfg, opt, microbatches=t["microbatches"],
                           lr_fn=cosine_schedule(t["lr"], t["warmup"],
                                                 t["total_steps"]),
                           in_place=True)
    readings = {"losses": []}
    for i in range(t["checked_steps"]):
        batch = traffic.train_batch(cell.mix, seed, i, cfg["vocab_size"],
                                    device)
        state, metrics = step(state, batch)
        readings["losses"].append(float(metrics["loss"]))
        if i == 0:
            readings["grad"] = norms(state.opt_state["m"], 1 / (1 - t["b1"]))
        if i + 1 == t["reference_steps"]:
            readings["change"] = change_norms(state.named(), cfg, seed)
    return state, step, readings


def change_norms(params: dict, cfg: dict, seed: int) -> dict[str, float]:
    """|params - the weights made from the seed| of every leaf, one group
    of weights made again at a time."""
    out = {}
    for index, (group, specs) in enumerate(ref.specs(cfg)):
        dev = next(iter(params.values())).device
        start = W.make_group(specs, seed, index, W.DTYPES[cfg["dtype"]], dev)
        for name, p0 in start.items():
            out[name] = float(torch.linalg.vector_norm(
                params[name].float() - p0.float()))
    return out


def window(cell: Cell, state, step, seed: int, seconds: float, device,
           clock=time.perf_counter) -> dict:
    """Train until ``seconds`` have passed; each step's end on the host
    clock (after a synchronise)."""
    first = cell.spec["train"]["checked_steps"]
    vocab = cell.config["vocab_size"]
    _sync(device)
    t0 = clock()
    ends, i = [], first
    while not ends or ends[-1] - t0 < seconds:
        batch = traffic.train_batch(cell.mix, seed, i, vocab, device)
        state, _ = step(state, batch)
        _sync(device)
        ends.append(clock())
        i += 1
    return {"t0": t0, "ends": ends, "next": i}


def trace_steps(cell: Cell, state, step, seed: int, first: int, device
                ) -> dict:
    """Profile TRACE_STEPS steps after the window, with spans around the
    step, its forward and loss, and its AdamW update."""
    from repro_torch.train import loop as L
    vocab = cell.config["vocab_size"]
    saved = (L.loss_fn, L.adamw_update)

    def spanned(name, fn):
        def call(*a, **k):
            with devtrace.span(name):
                return fn(*a, **k)
        return call

    def sub_window():
        with devtrace.span("window"):
            for i in range(first, first + TRACE_STEPS):
                batch = traffic.train_batch(cell.mix, seed, i, vocab, device)
                with devtrace.span("train_step"):
                    step(state, batch)
                _sync(device)

    L.loss_fn = spanned("forward_loss", saved[0])
    L.adamw_update = spanned("adamw_update", saved[1])
    try:
        got = devtrace.traced(torch, sub_window)
    finally:
        L.loss_fn, L.adamw_update = saved
    f, b = work.train_step(cell.config, cell.mix["batch"], cell.mix["seq_len"])
    got["work"] = [(f, b)] * TRACE_STEPS
    return got


def reference(cell: Cell, seed: int, device, prec: str = "f32",
              half_batch: bool = False) -> dict:
    """The reference's readings of the checked steps: losses of
    ``reference_steps + 1`` steps, the first clipped gradient's norms and
    the change after ``reference_steps`` AdamW steps, computed in float32
    (or the control's fp8) with the moments in float32 and the parameters
    held, between steps, in the configuration's dtype (bfloat16 weights
    cannot take an update under half their spacing, and the reference
    keeps what the configuration keeps). ``half_batch`` plants the fault
    of a step that leaves out half of each batch."""
    full_f32()
    t, cfg = cell.spec["train"], cell.config
    n = t["reference_steps"]
    if n not in (1, 2):
        raise ValueError("the reference follows one or two steps")
    p = Precision(prec)
    made = W.make(cfg, seed, device)
    held = {k: v.dtype for k, v in made.items()}
    w = {k: v.float() for k, v in made.items()}
    del made

    def batch(i):
        b = traffic.train_batch(cell.mix, seed, i, cfg["vocab_size"], device)
        if half_batch:
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        return b["tokens"], b["labels"]

    out = {"losses": []}
    kept = None                       # the first step's clipped gradient
    for i in range(n):
        value, g = ref.loss(w, cfg, *batch(i), p)
        out["losses"].append(float(value))
        gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(x)) ** 2
                              for x in g.values()))
        scale = min(1.0, t["clip_norm"] / max(gnorm, 1e-9))
        b1, b2, eps, wd = t["b1"], t["b2"], t["eps"], t["weight_decay"]
        c1, c2 = 1 - b1 ** (i + 1), 1 - b2 ** (i + 1)
        lr = lr_at(t, i)
        with torch.no_grad():
            for k in list(g):
                gs = g.pop(k).mul_(scale)
                if i == 0:
                    m, v = (1 - b1) * gs, (1 - b2) * gs * gs
                else:
                    a = kept[k]
                    m = b1 * (1 - b1) * a + (1 - b1) * gs
                    v = b2 * (1 - b2) * a * a + (1 - b2) * gs * gs
                w[k] -= lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                              + wd * w[k])
                # the parameters are kept in the configuration's dtype
                w[k].copy_(w[k].to(held[k]))
                if i == 0:
                    g[k] = gs
                del m, v
            if i == 0:
                out["grad"] = norms(g)
                kept = g
        del g
    kept = None
    out["change"] = change_norms(w, cfg, seed)
    value, _ = ref.loss(w, cfg, *batch(n), p, grads=False)
    out["losses"].append(float(value))
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_process: float, clock=time.perf_counter) -> dict:
    t = clock()
    state, step, prog = program(cell, seed, device)
    info = {"program_setup_s": clock() - t}
    win = window(cell, state, step, seed, seconds, device, clock)
    setup_s = win["t0"] - t_process
    ends = [win["t0"]] + win["ends"]
    info.update(steps=len(win["ends"]),
                step_ms=[round((b - a) * 1e3, 2) for a, b in zip(ends, ends[1:])])
    t = clock()
    traced = (trace_steps(cell, state, step, seed, win["next"], device)
              if trace else None)
    info["trace_s"] = clock() - t
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    del state, step
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t = clock()
    refr = reference(cell, seed, device)
    info["reference_s"] = clock() - t
    prog["losses"] = prog["losses"][: cell.spec["train"]["reference_steps"] + 1]
    info["losses"] = [prog["losses"], refr["losses"]]
    return {"setup_s": setup_s, "peak": peak, "window": win,
            "program": prog, "reference": refr, "traced": traced,
            "info": info}
