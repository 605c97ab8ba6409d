"""The comparisons that decide ``correct``, each number beside its limit.

Serving: the sampled requests' prompts and served tokens go once through
the float32 reference; ``gap_max`` is the widest gap by which a served
token's reference logit lies below the reference's best at that position
(0 where the two agree on every token), ``gap_mean`` the mean gap over the
served tokens. A cell's file says which it compares. Training: ``loss_gap`` is the
relative gap of the first step's loss; ``grad_gap`` and
``change_gap`` are the worst leaf's gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf and
of the median leaf: the first gradient as AdamW got it, and the change of
the parameters over the reference's steps. Leaves whose first gradient is
under a thousandth of the median leaf's are left out of the change.
"""

from __future__ import annotations

import statistics

import torch

from perfbench.reference import model as ref
from perfbench.reference.common import Precision, full_f32

#: leaves whose reference gradient is under this share of the median
#: leaf's move by rounding alone
NOUGHT = 1e-3


def token_gaps(logits, toks) -> torch.Tensor:
    """Every served token's gap below the reference's best at its row."""
    return torch.cat([lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0]
                      for lg, t in zip(logits, toks)])


def served_gaps(weights: dict, cfg: dict, seqs, rows, toks,
                lower: tuple[str, ...] = ()) -> tuple[torch.Tensor, dict]:
    """The served tokens' gaps below the float32 reference's best, and for
    each precision of ``lower`` the gaps of the tokens that the reference
    computed in it puts first at the same rows."""
    full_f32()
    logits = ref.served_logits(weights, cfg, seqs, rows, Precision("f32"))
    out = {}
    for name in lower:
        low = ref.served_logits(weights, cfg, seqs, rows, Precision(name))
        out[name] = token_gaps(logits, [lg.argmax(-1) for lg in low])
        del low
    return token_gaps(logits, toks), out


def gap_stats(gaps: torch.Tensor) -> dict:
    g = gaps.double()
    return {"max": float(g.max()), "mean": float(g.mean()),
            "p99": float(torch.quantile(g, 0.99)),
            "flipped": float((g > 0).double().mean()), "tokens": len(g)}


def leaf_gap(prog: dict[str, float], refn: dict[str, float],
             keep=None) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    names = [k for k in refn if keep is None or k in keep]
    med = statistics.median(refn[k] for k in names)
    return max(abs(prog[k] - refn[k]) / max(refn[k], med) for k in names)


def moving(grad_norms: dict[str, float]) -> set[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v >= NOUGHT * med}


def loss_gaps(prog: dict, refr: dict) -> list[float]:
    """Each checked step's |program loss - reference loss| / reference."""
    return [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 refr["losses"])]


def train_numbers(prog: dict, refr: dict) -> dict[str, float]:
    """loss_gap (the first step's: the later steps' losses also carry the
    rounding of bf16-held parameters, and swing from seed to seed),
    grad_gap and change_gap of the program's readings against the
    reference's (each a dict of ``losses``, ``grad`` and ``change``)."""
    return {"loss_gap": loss_gaps(prog, refr)[0],
            "grad_gap": leaf_gap(prog["grad"], refr["grad"]),
            "change_gap": leaf_gap(prog["change"], refr["change"],
                                   moving(refr["grad"]))}


def verdict(numbers: dict[str, float], limits: dict[str, float]
            ) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"]
             for v in checks.values())
    return ok, checks


def norms(tensors: dict[str, torch.Tensor], scale: float = 1.0
          ) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.float())) * scale
            for k, t in tensors.items()}
