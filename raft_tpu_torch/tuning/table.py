"""Persisted per-backend dispatch tables.

Counterpart of ``raft_tpu/tuning/table.py``, in full: a JSON table per
backend mapping (op, shape key) -> measured winner, consulted through
``raft_tpu_torch.tuning.choose``. The format is the reference's, so a
table written by either package reads in the other::

    {
      "version": 1,
      "backend": "cpu",
      "captured": "2026-08-03T00:00:00Z",
      "device": "TFRT_CPU_0",
      "ops": {
        "select_k": {
          "entries": [
            {"key": {"n": 65536, "k": 1024, "batch": 64,
                     "dtype": "float32"},
             "winner": "tournament",
             "times_ms": {"top_k": 12.1, "tournament": 5.3}},
            ...
          ]
        },
        ...
      },
      "budgets": {"cagra_inline_bytes": 6442450944}
    }

Lookup is piecewise-constant nearest-neighbour interpolation: string and
bool key fields must match exactly, numeric fields are compared in log2
space, and a query farther than ``max_l2`` (RMS log2 distance, default 2
octaves a field) from every entry is a miss — the caller then takes its
analytic pick. Entries whose winner is not in the caller's candidate set
are skipped.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

TABLE_VERSION = 1

# the miss radius: RMS log2 distance over the numeric key fields (2.0 is
# within ~4x a field on average)
DEFAULT_MAX_L2 = 2.0


def _key_distance(query: Dict, entry_key: Dict) -> Optional[float]:
    """RMS log2 distance over the numeric fields both keys share; None
    (a mismatch) when a shared string or bool field differs, or when a
    non-empty query shares no field with the entry."""
    acc = 0.0
    ndims = 0
    ncat = 0
    for f, qv in query.items():
        if f not in entry_key:
            continue
        ev = entry_key[f]
        if isinstance(qv, str) or isinstance(ev, str):
            if str(qv) != str(ev):
                return None
            ncat += 1
            continue
        if isinstance(qv, bool) or isinstance(ev, bool):
            if bool(qv) != bool(ev):
                return None
            ncat += 1
            continue
        q = max(float(qv), 1e-30)
        e = max(float(ev), 1e-30)
        acc += math.log2(q / e) ** 2
        ndims += 1
    if ndims == 0:
        # only categorical fields shared: an exact match; none: a miss
        return 0.0 if (ncat > 0 or not query) else None
    return math.sqrt(acc / ndims)


class DispatchTable:
    """One backend's measured dispatch table."""

    def __init__(self, data: Optional[Dict] = None):
        self.data = data or {
            "version": TABLE_VERSION,
            "backend": "unknown",
            "ops": {},
            "budgets": {},
        }
        self.data.setdefault("ops", {})
        self.data.setdefault("budgets", {})

    @classmethod
    def load(cls, path: str) -> "DispatchTable":
        with open(path) as f:
            data = json.load(f)
        if int(data.get("version", 0)) != TABLE_VERSION:
            raise ValueError(
                f"dispatch table {path} has version "
                f"{data.get('version')!r}; this build reads "
                f"{TABLE_VERSION}")
        return cls(data)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    def record(self, op: str, key: Dict, times_ms: Dict[str, float]) -> str:
        """Insert or replace the measurement for (op, key); returns the
        winner (the fastest finite candidate)."""
        finite = {c: t for c, t in times_ms.items()
                  if t is not None and math.isfinite(t)}
        if not finite:
            raise ValueError(f"no finite timing for {op} {key}")
        winner = min(finite, key=finite.get)
        times = {c: round(float(t), 4) for c, t in finite.items()}
        entries = self.data["ops"].setdefault(op, {}).setdefault(
            "entries", [])
        for e in entries:
            if e["key"] == key:
                e["winner"] = winner
                e["times_ms"] = times
                return winner
        entries.append({"key": dict(key), "winner": winner,
                        "times_ms": times})
        return winner

    def set_budget(self, name: str, value: int) -> None:
        self.data["budgets"][name] = int(value)

    def lookup(self, op: str, key: Dict,
               candidates: Optional[List[str]] = None,
               max_l2: float = DEFAULT_MAX_L2) -> Optional[str]:
        """The nearest entry's winner for ``key``, or None on a miss
        (unknown op, no entry whose winner is a candidate, or the nearest
        farther than ``max_l2``)."""
        best = None
        best_d = None
        for e in self.data["ops"].get(op, {}).get("entries", []):
            w = e.get("winner")
            if candidates is not None and w not in candidates:
                continue
            d = _key_distance(key, e.get("key", {}))
            if d is None or d > max_l2:
                continue
            if best_d is None or d < best_d:
                best, best_d = w, d
        return best

    def lookup_entry(self, op: str, key: Dict,
                     max_l2: float = DEFAULT_MAX_L2) -> Optional[Dict]:
        """The nearest full entry (key, winner, times_ms) for ``key``, or
        None on a miss."""
        best = None
        best_d = None
        for e in self.data["ops"].get(op, {}).get("entries", []):
            d = _key_distance(key, e.get("key", {}))
            if d is None or d > max_l2:
                continue
            if best_d is None or d < best_d:
                best, best_d = e, d
        return best

    def budget(self, name: str) -> Optional[int]:
        v = self.data.get("budgets", {}).get(name)
        return None if v is None else int(v)

    def ops(self) -> List[str]:
        return sorted(self.data["ops"].keys())

    def n_entries(self, op: Optional[str] = None) -> int:
        if op is not None:
            return len(self.data["ops"].get(op, {}).get("entries", []))
        return sum(len(o.get("entries", []))
                   for o in self.data["ops"].values())
