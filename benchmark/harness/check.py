"""The numbers that decide ``correct``, each against its limit.

Serving: over a sample of finished requests, the widest gap by which a
served token's logit lies below the reference's best, and the requests
that stopped short of the tokens they asked for."""
from __future__ import annotations

from typing import Dict, List


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """[{name, value, limit, ok}] for every limit; a number missing or not
    finite fails."""
    out = []
    for name, limit in limits.items():
        v = numbers.get(name)
        ok = v is not None and v == v and v <= limit
        out.append({"name": name, "value": v, "limit": limit, "ok": ok})
    return out


def failed_by(reading: Dict[str, float], limits: Dict[str, float]
              ) -> List[str]:
    """The limits that a control's or a fault's ``reading`` fails, judged
    as a run's numbers are, over the numbers it reads."""
    held = {n: v for n, v in limits.items() if n in reading}
    return [c["name"] for c in judge(reading, held) if not c["ok"]]
