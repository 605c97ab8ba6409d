"""A serving cell: the program's ``PagedServeEngine`` driven by an open
or a closed loop, timed by the host clock, then judged.

Every request is timed from when it was due (open loop) or sent (closed
loop). The engine's ``step`` is the only call the window makes into the
program; after each tick the loop reads the tokens each request holds and
stamps them with the tick's end, when they reach the host. The window
opens ``ramp_s`` after the traffic starts. Open loop: arrivals go on at
the mix's rate after the window closes until every request due in it has
streamed two tokens (its time to first token and its time per output
token are then known; the longest outputs take minutes and are not
waited for); one with no token a minute past the close (or a window's
length, if longer) failed. Closed loop: the window's tokens are counted
as they come, and the run ends with it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from perfbench import devtrace, traffic, work
from perfbench import weights as W
from perfbench.manifest import Cell, port_config

#: seconds of the traced sub-window, after the measured window
TRACE_S = 2.0
#: requests a closed-loop client has planned
PER_CLIENT = 40


@dataclasses.dataclass
class Track:
    """What the host saw of one request."""
    planned: traffic.Planned
    req: object
    due: float                     # host clock
    admit: float | None = None     # end of the first tick that gave it a slot
    first: float | None = None
    last: float | None = None
    done: float | None = None
    seen: int = 0                  # tokens that reached the host
    n: int = 0                     # tokens the engine held after the last tick
    prefill: int = 0               # prompt tokens the engine had prefilled
    in_window_tokens: int = 0


class Loop:
    """The traffic, the engine and the host's books of one run."""

    def __init__(self, cell: Cell, engine, seed: int, seconds: float,
                 clock=time.perf_counter):
        from repro_torch.serve.engine import Request
        self.Request = Request
        self.cell, self.engine, self.clock = cell, engine, clock
        self.mix = cell.mix
        self.closed = self.mix["loop"] == "closed"
        self.seconds = seconds
        self.ramp = float(self.mix["ramp_s"])
        self.drain = max(60.0, seconds)
        vocab = cell.config["vocab_size"]
        if self.closed:
            self.lists = traffic.closed_loop(self.mix, seed, vocab, PER_CLIENT)
            self.next_send = [traffic.client_start(self.mix, c)
                              for c in range(self.mix["clients"])]
            self.sent = [0] * self.mix["clients"]
        else:
            self.plan = traffic.open_loop(
                self.mix, seed, vocab,
                [self.ramp, seconds, self.drain, self.drain])
            self.next_due = 0
        self.tracks: list[Track] = []
        self.live: list[Track] = []
        self.ticks: list[dict] = []
        self.record_ticks = True
        self.t0 = None

    # -- the clock -----------------------------------------------------------

    def start(self) -> None:
        self.t0 = self.clock()
        self.w0 = self.t0 + self.ramp
        self.w1 = self.w0 + self.seconds

    def in_window(self, t: float) -> bool:
        return self.w0 <= t <= self.w1

    # -- sending -------------------------------------------------------------

    def _submit(self, planned: traffic.Planned, due: float) -> None:
        req = self.Request(uid=planned.uid, prompt=planned.prompt.astype(np.int32),
                           max_new_tokens=planned.max_new)
        self.engine.submit(req)
        tr = Track(planned, req, due)
        self.tracks.append(tr)
        self.live.append(tr)

    def _send_due(self, now: float) -> float | None:
        """Submit what is due; the time of the next send (None: none left)."""
        if self.closed:
            nxt = None
            for c, at in enumerate(self.next_send):
                if at is None:
                    continue
                if self.t0 + at <= now:
                    if self.sent[c] < len(self.lists[c]):
                        self._submit(self.lists[c][self.sent[c]], self.t0 + at)
                        self.sent[c] += 1
                    self.next_send[c] = None
                elif nxt is None or self.t0 + at < nxt:
                    nxt = self.t0 + at
            return nxt
        while (self.next_due < len(self.plan)
               and self.t0 + self.plan[self.next_due].due <= now):
            p = self.plan[self.next_due]
            self._submit(p, self.t0 + p.due)
            self.next_due += 1
        if self.next_due < len(self.plan):
            return self.t0 + self.plan[self.next_due].due
        return None

    # -- one turn of the loop ------------------------------------------------

    def turn(self, trace: bool = False) -> None:
        """Send what is due, then one engine tick (or wait for the next
        send when the engine has nothing to do), then read the tokens."""
        now = self.clock()
        with devtrace.span("send", trace):
            nxt = self._send_due(now)
        eng = self.engine
        if not (eng.waiting or eng.prefilling or eng.active or eng.ready):
            if nxt is not None:
                time.sleep(max(0.0, min(nxt - self.clock(), 0.005)))
            return
        start = self.clock()
        with devtrace.span("engine_step", trace):
            eng.step()
        end = self.clock()
        with devtrace.span("books", trace):
            self._observe(start, end)

    def _observe(self, start: float, end: float) -> None:
        decode_ctx, chunks, still = [], [], []
        for tr in self.live:
            req = tr.req
            plen = len(tr.planned.prompt)
            if tr.admit is None and req.slot is not None:
                tr.admit = end
            n, pp = len(req.generated), req.prefill_pos
            if n < tr.n or pp < tr.prefill:        # preempted: rolled back
                tr.n, tr.prefill = n, pp
            completed = pp == plen and tr.prefill < plen and n > tr.n
            if pp > tr.prefill:
                chunks.append((tr.prefill, pp))
            if n - tr.n - int(completed) > 0:
                decode_ctx.append(plen + n - 1)
            tr.n, tr.prefill = n, pp
            if n > tr.seen:
                if tr.first is None:
                    tr.first = end
                tr.last = end
                if self.in_window(end):
                    tr.in_window_tokens += n - tr.seen
                tr.seen = n
            if req.done:                 # the engine finished it this tick
                tr.done = end
                if self.closed:
                    self.next_send[tr.planned.client] = end - self.t0
            else:
                still.append(tr)
        self.live = still
        if self.record_ticks:
            self.ticks.append({"start": start, "end": end,
                               "decode_ctx": decode_ctx, "chunks": chunks})

    # -- the run -------------------------------------------------------------

    def window_due(self) -> list[Track]:
        """Open loop: the requests due in the window."""
        return [t for t in self.tracks if self.in_window(t.due)]

    def run(self) -> None:
        self.start()
        while True:
            self.turn()
            now = self.clock()
            if now < self.w1:
                continue
            if self.closed:
                return
            due = self.window_due()
            if (all(t.seen >= 2 or t.done is not None for t in due)
                    or now > self.w1 + self.drain):
                return


def warm_up(engine, cfg: dict, Request) -> None:
    """One request of two prefill chunks and a few decode ticks: the two
    shapes the engine's step takes, (1, prefill_chunk) and (slots, 1)."""
    prompt = np.arange(engine.prefill_chunk + 1, dtype=np.int32) % cfg["vocab_size"]
    engine.submit(Request(uid=-1, prompt=prompt, max_new_tokens=4))
    while engine.waiting or engine.prefilling or engine.active:
        engine.step()
    engine.finished.clear()


def build(cell: Cell, seed: int, device):
    """The weights made from the seed and the engine over them."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import PagedServeEngine, Request
    weights = W.make(cell.config, seed, device)
    params = T.from_named(port_config(cell.config), weights)
    e = cell.spec["engine"]
    engine = PagedServeEngine(params.cfg, params, max_slots=e["max_slots"],
                              max_len=e["max_len"],
                              prefill_chunk=e.get("prefill_chunk"),
                              page_len=e.get("page_len"),
                              num_pages=e.get("num_pages"))
    warm_up(engine, cell.config, Request)
    return weights, engine


def sample(loop: Loop, seed: int, spec: dict) -> list[Track]:
    """The requests whose served tokens the check compares: the longest
    one the run finished, then others it finished drawn from the seed,
    until ``served_tokens`` tokens or ``max_requests`` requests."""
    judged = [t for t in loop.tracks if t.done is not None]
    if not judged:
        return []
    longest = max(judged, key=lambda t: len(t.planned.prompt) + t.seen)
    rest = [t for t in judged if t is not longest]
    order = np.random.default_rng(W.sub_seed(seed, 5)).permutation(len(rest))
    out, tokens = [longest], longest.seen
    for i in order:
        if tokens >= spec["served_tokens"] or len(out) >= spec["max_requests"]:
            break
        out.append(rest[i])
        tokens += rest[i].seen
    return out


def judged_requests(loop: Loop) -> list[Track]:
    """Open loop: the requests due in the window; closed: those that
    finished in it."""
    if loop.closed:
        return [t for t in loop.tracks
                if t.done is not None and loop.in_window(t.done)]
    return loop.window_due()


def served(tracks: list[Track], device):
    """(sequences, rows, tokens): each sampled request's prompt with its
    served tokens but the last, the rows whose next token was served, and
    those tokens."""
    seqs, rows, toks = [], [], []
    for t in tracks:
        gen = list(t.req.generated)
        p = t.planned.prompt.astype(np.int64)
        seq = np.concatenate([p, np.asarray(gen[:-1], dtype=np.int64)])
        seqs.append(torch.as_tensor(seq, device=device))
        rows.append(torch.arange(len(p) - 1, len(p) - 1 + len(gen),
                                 device=device))
        toks.append(torch.as_tensor(gen, dtype=torch.long, device=device))
    return seqs, rows, toks


def end_to_end(loop: Loop) -> dict:
    """The window's end-to-end numbers and its request counts."""
    judged = judged_requests(loop)
    tokens = sum(t.in_window_tokens for t in loop.tracks)
    waited = loop.w1 + loop.drain
    ttft = [((t.first if t.first is not None else waited) - t.due) * 1e3
            for t in judged]
    tpot = [(t.last - t.first) / (t.seen - 1) * 1e3 for t in judged
            if t.seen >= 2]
    failed = sum(t.first is None for t in judged)
    return {"output_tok_s": tokens / loop.seconds,
            "ttft": ttft, "tpot": tpot,
            "attempted": len(judged), "failed": failed}


def tick_work(cfg: dict, ticks: list[dict]) -> list[tuple[float, float]]:
    return [work.serve_tick(cfg, t["decode_ctx"], t["chunks"]) for t in ticks]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_process: float, clock=time.perf_counter) -> dict:
    """One run of a serving cell: everything the result line needs."""
    cfg = cell.config
    t = clock()
    weights, engine = build(cell, seed, device)
    info = {"build_s": clock() - t, "page_len": engine.page_len,
            "num_pages": engine.alloc.num_pages}
    loop = Loop(cell, engine, seed, seconds, clock)
    loop.run()
    setup_s = loop.w0 - t_process
    win = [t for t in loop.ticks if loop.in_window(t["start"])]
    info.update(ticks=len(win), drain_s=loop.clock() - loop.w1,
                tick_ms=sum(t["end"] - t["start"] for t in win)
                / max(1, len(win)) * 1e3,
                decode_rows=sum(len(t["decode_ctx"]) for t in win)
                / max(1, len(win)), preemptions=engine.preemptions,
                peak_pages=engine.peak_pages)
    traced = None
    if trace:
        t = clock()
        traced = trace_window(loop)
        info["trace_s"] = clock() - t
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    e2e = end_to_end(loop)
    picked = sample(loop, seed, cell.spec["sample"])
    engine.cache = None
    loop.engine = None
    del engine
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    info["sampled_tokens"] = sum(t.seen for t in picked)
    return {"loop": loop, "setup_s": setup_s, "peak": peak, "e2e": e2e,
            "sample": picked, "weights": weights, "traced": traced,
            "config": cfg, "info": info}


def trace_window(loop: Loop) -> dict:
    """Profile a steady sub-window of TRACE_S seconds after the measured
    one: the traffic goes on, the spans mark the loop's calls."""
    loop.record_ticks = False
    state = {}

    def sub_window():
        loop.record_ticks = True
        first = len(loop.ticks)
        with devtrace.span("window"):
            t_end = loop.clock() + TRACE_S
            while loop.clock() < t_end:
                loop.turn(trace=True)
        state["ticks"] = loop.ticks[first:]
        loop.record_ticks = False

    got = devtrace.traced(torch, sub_window)
    got["work"] = tick_work(loop.cell.config, state["ticks"])
    return got
