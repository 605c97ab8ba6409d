"""Traffic from a mix file and ``--seed``: a pure function of the two.

Lengths are Gamma draws (``shape``, ``mean``) rounded and clipped to
``[lo, hi]``, as Splitwise characterises its traces. The schedule (the
lengths, the gaps and their order) is one trace drawn from the mix's
``base_seed`` and replayed by every run; the run's seed draws the token
ids (and the weights). With heavy-tailed lengths and some tens of
requests in a window, even the order of one set of lengths changes the
work a window holds (two sets of six runs of granite-8b.chat on six seeds
read 62-83 tokens/s, each seed within 0.2% of itself), so only the ids
vary: the same work on every seed.

- Open loop: arrivals are a Poisson process at ``rate_rps`` by the wall
  clock, cut into phases (the ramp, the window, the tail after it); each
  phase holds exactly ``round(rate * length)`` requests whose gaps are
  exponential draws scaled to fill it.
- Closed loop: ``clients`` clients, client ``c`` starting
  ``c * start_spread_s / clients`` after the first, each sending its next
  request when its last one finishes, from a list of its own.
- Training: one batch of ``batch`` rows of ``seq_len + 1`` token ids a
  step, made on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.weights import sub_seed


@dataclasses.dataclass
class Planned:
    """One request as the traffic plans it: due time (seconds after the
    traffic starts; None for a closed-loop request, due when its client
    sends it), the prompt's token ids and the tokens to generate."""
    uid: int
    due: float | None
    prompt: np.ndarray
    max_new: int
    client: int = -1


def gamma_lengths(rng: np.random.Generator, dist: dict, n: int) -> np.ndarray:
    """``n`` lengths: Gamma(shape, mean/shape), rounded, clipped."""
    shape = dist["shape"]
    vals = np.rint(rng.gamma(shape, dist["mean"] / shape, size=n))
    return np.clip(vals, dist["lo"], dist["hi"]).astype(np.int64)


def _phase(mix: dict, phase: int, start: float, length: float
           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(due times, prompt lengths, output lengths) of one phase."""
    n = int(round(mix["rate_rps"] * length))
    if n == 0:
        return np.zeros(0), np.zeros(0, np.int64), np.zeros(0, np.int64)
    base = np.random.default_rng([mix["base_seed"], phase])
    gaps = base.exponential(1.0, size=n + 1)
    plen = gamma_lengths(base, mix["prompt"], n)
    olen = gamma_lengths(base, mix["output"], n)
    due = start + np.cumsum(gaps)[:n] * (length / gaps.sum())
    return due, plen, olen


def open_loop(mix: dict, seed: int, vocab: int, phases: list[float]
              ) -> list[Planned]:
    """The requests of an open-loop mix over consecutive phases of the
    given lengths (seconds), sorted by due time."""
    ids = np.random.default_rng(sub_seed(seed, 3))
    out, start = [], 0.0
    for p, length in enumerate(phases):
        due, plen, olen = _phase(mix, p, start, length)
        for t, lp, lo in zip(due, plen, olen):
            out.append(Planned(len(out), float(t),
                               ids.integers(0, vocab, size=int(lp)),
                               int(lo)))
        start += length
    return out


def closed_loop(mix: dict, seed: int, vocab: int, per_client: int
                ) -> list[list[Planned]]:
    """Each client's list of ``per_client`` requests: the lengths drawn
    from ``base_seed``, dealt out in turn to the clients."""
    clients = mix["clients"]
    n = clients * per_client
    base = np.random.default_rng([mix["base_seed"], 0])
    plen = gamma_lengths(base, mix["prompt"], n)
    olen = gamma_lengths(base, mix["output"], n)
    ids = np.random.default_rng(sub_seed(seed, 3))
    out = [[] for _ in range(clients)]
    for j in range(n):
        c = j % clients
        out[c].append(Planned(j, None, ids.integers(0, vocab, size=int(plen[j])),
                              int(olen[j]), client=c))
    return out


def client_start(mix: dict, client: int) -> float:
    return client * mix.get("start_spread_s", 0.0) / mix["clients"]


def train_batch(mix: dict, seed: int, step: int, vocab: int, device
                ) -> dict[str, torch.Tensor]:
    """Step ``step``'s batch: tokens and next-token labels (B, seq_len),
    made on the device from the seed and the step, every row new."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 4, step))
    t = torch.randint(0, vocab, (mix["batch"], mix["seq_len"] + 1),
                      generator=gen, device=device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}

