"""Batched torch cache-simulation engine: many candidate lanes per call.

The port's twin of ``repro/core/cachesim_jax.py``. :class:`BatchCache` is
the third engine in the oracle chain ``Cache`` (per-access reference) →
``VectorCache`` (numpy chunk stepping) → ``BatchCache`` (this module),
with the reference's contract: one lane = one geometry + one address
stream, every lane simulated from cold by one ``simulate()`` call.

Two execution paths sit behind it, as in the reference:

* **cyclic closed form** — uniform chases and the ``find_set_bits``
  probes tile a one-pass pattern that visits each distinct line in a
  single consecutive run; under LRU/FIFO the hit/miss stream then follows
  in closed form on the host (:meth:`BatchCache.periodic_masks`,
  :meth:`BatchCache.steady_miss_count`), copied from the reference in
  numpy. Every probe of the blind dissection resolves here.
* **scan** — arbitrary streams and the stochastic policies go through
  :func:`repro_torch.kernels.batch_cache.batch_cache_scan` on the
  engine's device: a CUDA kernel on the card, its plain PyTorch version on
  the CPU. For deterministic policies the scan is bit-exact against the
  reference oracle.

**RNG lanes.** The numpy oracle draws ``random``/``prob`` victims from a
serial generator; the scan takes one uniform a step, drawn once per call
with a CPU ``torch.Generator`` seeded by :attr:`BatchCache.seed`, so the
kernel and its plain version see the same draws. Victim *distributions*
match the oracle's, draws do not, so stochastic lanes are validated
distributionally and the trace cache keys this engine's traces under
:data:`~repro_torch.core.cachesim.TORCH_ENGINE_VERSION`.

Prefetch geometries are rejected, as the reference rejects them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cachesim import (  # noqa: F401
    CacheGeometry, TORCH_ENGINE_VERSION,
)
from repro_torch.kernels import batch_cache
from repro_torch.kernels.ref import POLICY_CODE

__all__ = ["BatchCache", "TORCH_ENGINE_VERSION"]


def _bucket(n: int) -> int:
    """Round up to a power of two, as the reference buckets its padded
    (B, T, W, K) shapes."""
    return 1 << max(0, int(n - 1).bit_length())


class BatchCache:
    """Batched cache simulator over candidate lanes.

    ``geoms`` fixes one :class:`CacheGeometry` per lane (heterogeneous
    sizes, set counts, way counts and policies are all allowed; the
    inputs are padded to the widest lane). ``device`` is where the scan
    runs: ``cuda`` unless the caller asks for ``cpu``. A lane's hit/miss
    stream is a pure function of ``(geometry, stream, seed)``.
    """

    def __init__(self, geoms: Sequence[CacheGeometry] | CacheGeometry, *,
                 seed: int = 0, device: str | torch.device | None = None):
        if isinstance(geoms, CacheGeometry):
            geoms = [geoms]
        self.geoms = list(geoms)
        self.seed = seed
        self.device = resolve_device(device)
        for g in self.geoms:
            if g.prefetch_lines:
                raise ValueError(
                    f"BatchCache does not support prefetch geometries "
                    f"({g.name!r} has prefetch_lines={g.prefetch_lines})")
            if g.replacement.kind not in POLICY_CODE:
                raise ValueError(
                    f"unknown replacement policy {g.replacement.kind!r}")

    # -- closed form --------------------------------------------------------

    def steady_miss_count(self, lane: int,
                          line_addrs: np.ndarray) -> float | None:
        """Steady-state misses per pass of a cyclic chase, in closed form.

        ``line_addrs`` lists the distinct line addresses one pass visits
        (each exactly once, in consecutive runs).  Under LRU/FIFO the
        steady per-pass miss count is the number of lines living in
        over-subscribed sets: ``sum(d_s for sets with d_s > w_s)``.
        Returns None when the lane's policy has no closed form.
        """
        g = self.geoms[lane]
        if g.replacement.kind not in ("lru", "fifo"):
            return None
        sets = np.asarray(g.vector_mapper()(
            np.asarray(line_addrs, dtype=np.int64)), dtype=np.int64)
        d = np.bincount(sets, minlength=g.num_sets)
        w = np.asarray(g.way_counts, dtype=np.int64)
        thrash = d > w
        return float(d[thrash].sum())

    def periodic_masks(self, lane: int, pass_addrs: np.ndarray,
                       ) -> tuple[np.ndarray, np.ndarray] | None:
        """Positional closed form for one pass of a cyclic chase.

        Returns ``(miss_cold, miss_steady)`` per-access miss masks for
        the first (cold) pass and for any steady pass, or None when the
        closed form does not apply: non-LRU/FIFO policy, or a pass that
        revisits a line in more than one run (the caller falls back to
        the scan path).  The steady mask treats the pass as cyclic, so a
        line run that wraps across the pass boundary stays one run.
        """
        g = self.geoms[lane]
        if g.replacement.kind not in ("lru", "fifo"):
            return None
        addrs = np.asarray(pass_addrs, dtype=np.int64)
        if addrs.size == 0:
            return None
        sets = np.asarray(g.vector_mapper()(addrs), dtype=np.int64)
        tags = addrs // g.line_bytes
        keys = tags * g.num_sets + sets
        first = np.empty(len(keys), dtype=bool)
        first[0] = True
        np.not_equal(keys[1:], keys[:-1], out=first[1:])
        first_cyc = first.copy()
        first_cyc[0] = keys[0] != keys[-1]
        starts = keys[first_cyc]
        if starts.size == 0:                     # the whole pass is one line
            miss_cold = first.copy()
            return miss_cold, np.zeros(len(keys), dtype=bool)
        if np.unique(starts).size != starts.size:
            return None                          # a line split across runs
        d = np.bincount(sets[first_cyc], minlength=g.num_sets)
        w = np.asarray(g.way_counts, dtype=np.int64)
        thrash_set = d > w
        steady = first_cyc & thrash_set[sets]
        return first, steady

    def _try_periodic(self, lane: int,
                      addrs: np.ndarray) -> np.ndarray | None:
        """Hit stream for a stream that tiles a cyclic one-pass pattern."""
        g = self.geoms[lane]
        if g.replacement.kind not in ("lru", "fifo") or addrs.size == 0:
            return None
        occ = np.flatnonzero(addrs == addrs[0])
        periods = [int(p) for p in occ[1:3]] or [len(addrs)]
        for p in periods:
            if not np.array_equal(addrs, np.resize(addrs[:p], len(addrs))):
                continue
            masks = self.periodic_masks(lane, addrs[:p])
            if masks is None:
                return None
            cold, steady = masks
            miss = np.resize(steady, len(addrs))
            m = min(p, len(addrs))
            miss[:m] = cold[:m]
            return ~miss
        return None

    # -- the batched scan engine --------------------------------------------

    def simulate(self, streams: Sequence[np.ndarray], *,
                 force_scan: bool = False) -> list[np.ndarray]:
        """Hit/miss streams for every lane, each simulated from cold.

        ``streams[i]`` is lane *i*'s byte-address stream; the result is a
        bool array of the same length (True = hit).  Cyclic LRU/FIFO
        lanes resolve through the closed form; everything else goes
        through one scan call on the engine's device (``force_scan=True``
        pins the two paths against each other in the differential tests).
        """
        if len(streams) != len(self.geoms):
            raise ValueError(f"{len(streams)} streams for "
                             f"{len(self.geoms)} lanes")
        out: list[np.ndarray | None] = [None] * len(streams)
        scan_lanes: list[tuple[int, np.ndarray]] = []
        for i, addrs in enumerate(streams):
            addrs = np.asarray(addrs, dtype=np.int64)
            if not force_scan:
                hits = self._try_periodic(i, addrs)
                if hits is not None:
                    out[i] = hits
                    continue
            scan_lanes.append((i, addrs))
        if scan_lanes:
            for (i, _), hits in zip(scan_lanes, self._scan(scan_lanes)):
                out[i] = hits
        return out  # type: ignore[return-value]

    def scan_inputs(self, lanes: list[tuple[int, np.ndarray]]
                    ) -> dict[str, torch.Tensor]:
        """The scan's padded inputs for ``(lane, byte addresses)`` pairs,
        on the engine's device: the arguments of
        :func:`~repro_torch.kernels.batch_cache.batch_cache_scan`."""
        geoms = [self.geoms[i] for i, _ in lanes]
        lens = [len(a) for _, a in lanes]
        b = _bucket(len(lanes))
        t = _bucket(max(g.num_sets for g in geoms))
        w = _bucket(max(max(g.way_counts) for g in geoms))
        k = _bucket(max(lens) if max(lens, default=0) else 1)

        ways = np.zeros((b, t), dtype=np.int32)
        policy = np.zeros(b, dtype=np.int32)
        probs = np.zeros((b, w), dtype=np.float32)
        sets = np.zeros((b, k), dtype=np.int32)
        lines = np.zeros((b, k), dtype=np.int32)
        valid = np.zeros((b, k), dtype=bool)
        for j, ((_, addrs), g) in enumerate(zip(lanes, geoms)):
            ways[j, :g.num_sets] = g.way_counts
            policy[j] = POLICY_CODE[g.replacement.kind]
            if g.replacement.way_probs:
                probs[j, :len(g.replacement.way_probs)] = g.replacement.way_probs
            s = np.asarray(g.vector_mapper()(addrs), dtype=np.int64)
            tag = addrs // g.line_bytes
            # factorize (line, set) pairs to dense int32 ids per lane so
            # the state planes stay int32
            _, inv = np.unique(tag * g.num_sets + s, return_inverse=True)
            n = len(addrs)
            sets[j, :n] = s
            lines[j, :n] = inv.reshape(-1)
            valid[j, :n] = True
        # the prob lanes' cumulative weights, once, sequentially in float32:
        # the kernel and its plain version read the same array
        cum = np.cumsum(probs, axis=1, dtype=np.float32)
        # per-step eviction uniforms, drawn once per call on the host
        u = torch.rand((b, k), dtype=torch.float32,
                       generator=torch.Generator().manual_seed(self.seed))
        host = dict(ways=ways, policy=policy, cum=cum, sets=sets, lines=lines,
                    valid=valid)
        out = {name: torch.from_numpy(a).to(self.device)
               for name, a in host.items()}
        out["u"] = u.to(self.device)
        return out

    def _scan(self, lanes: list[tuple[int, np.ndarray]]) -> list[np.ndarray]:
        hits = batch_cache.batch_cache_scan(**self.scan_inputs(lanes))
        hits = hits.cpu().numpy()
        return [hits[j, :len(a)] for j, (_, a) in enumerate(lanes)]
