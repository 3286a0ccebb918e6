"""The numbers that decide ``correct``, each against its limit.

``rel(p, r)`` is the norm of the difference over the reference's norm. A
number that is not finite fails.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import torch


def rel(p: torch.Tensor, r: torch.Tensor) -> float:
    p, r = p.float(), r.float().to(p.device)
    return (torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r)).item()


def worst_rel(ps: List[torch.Tensor], rs: List[torch.Tensor]) -> float:
    if len(ps) != len(rs):
        return math.inf
    return max(rel(p, r) for p, r in zip(ps, rs))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> (bool, Dict[str, dict]):
    """(every number finite and within its limit, {name: {value, limit}})."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = float(limits[name])
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    missing = set(limits) - set(numbers)
    for name in sorted(missing):
        ok = False
        checks[name] = {"value": None, "limit": float(limits[name])}
    return ok, checks


def print_checks(checks: Dict[str, dict], file=sys.stderr) -> None:
    """Each number beside its limit, as the last lines of standard error."""
    for name, c in checks.items():
        verdict = ("ok" if c["value"] is not None and math.isfinite(c["value"])
                   and c["value"] <= c["limit"] else "FAIL")
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {verdict}", file=file,
              flush=True)
