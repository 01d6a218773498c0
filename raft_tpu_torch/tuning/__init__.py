"""Table-driven dispatch: the part of ``raft_tpu/tuning/__init__.py`` that
the fold arms' choices need.

Consumers call ``choose(op, key, candidates, fallback, device=...)`` with
a static shape key; the answer comes from a persisted per-backend table
of measurements (``tables/<backend>.json``, :mod:`.table`), falling back
to the caller's analytic pick when no entry covers the key. Two choices
go through it here, as in the reference: ``fused_topk_tile``
(``neighbors.brute_force._resolve_bf_impl``, kernel 1's arm and row tile)
and ``ivf_scan_extract`` (``ops.ivf_scan``, kernel 2's extraction arm).
The mode is the reference's ``RAFT_TPU_TUNING``:

    RAFT_TPU_TUNING=off       always the analytic pick
    RAFT_TPU_TUNING=table     consult the table (default)
    RAFT_TPU_TUNING=measure   as "table" for every op of the port; the
                              reference's inline measurement of select_k /
                              merge_topk is not ported and raises

``RAFT_TPU_TUNING_TABLE=/path.json`` (or :func:`set_table_path`) overrides
the packaged table. The backend is the device of the call's tensors
(:func:`backend_name`): the port keeps no global one. The packaged
``cpu.json`` is the reference's; no ``cuda.json`` has been captured, so
every choice on the card takes the analytic pick unless a table is named.
The reference's budgets, its in-process measurement and its dispatch
counters (``obs``) are not ported (ROADMAP.md, Queue A item 1).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import torch

from raft_tpu_torch.tuning.table import DispatchTable

_MODES = ("off", "table", "measure")

# the fused brute-force kernel's row tiles, the candidates of
# ``fused_topk_tile`` (``fused_<variant>:<tile>``)
FUSED_TOPK_TILES = (512, 1024, 2048)
# ops.fused_topk.tile_geometry halves below the raced tiles down to this
FUSED_TOPK_TILE_FLOOR = 256

# the ops the reference measures in-process in "measure" mode
MEASURABLE_INLINE = ("select_k", "merge_topk")

_lock = threading.Lock()
_mode_override: Optional[str] = None
_table_path_override: Optional[str] = None
_table_cache: Dict[str, Optional[DispatchTable]] = {}


def mode() -> str:
    """The tuning mode: the ``set_mode`` override if any, else
    ``RAFT_TPU_TUNING`` (default "table")."""
    if _mode_override is not None:
        return _mode_override
    m = os.environ.get("RAFT_TPU_TUNING", "table").strip().lower()
    return m if m in _MODES else "table"


def set_mode(m: Optional[str]) -> None:
    """Override the environment's mode in-process (None restores it)."""
    global _mode_override
    if m is not None and m not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {m!r}")
    _mode_override = m


def backend_name(device=None) -> str:
    """The table stem for a call on ``device``: "cuda" for a CUDA device,
    "cpu" otherwise."""
    if device is not None and torch.device(device).type == "cuda":
        return "cuda"
    return "cpu"


def tables_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tables")


def table_path(device=None) -> Optional[str]:
    """The table a call on ``device`` reads: the ``set_table_path``
    override, then ``RAFT_TPU_TUNING_TABLE``, then the packaged table of
    its backend; None when none of these exists."""
    if _table_path_override is not None:
        return _table_path_override
    env = os.environ.get("RAFT_TPU_TUNING_TABLE", "").strip()
    if env:
        return env
    packaged = os.path.join(tables_dir(), backend_name(device) + ".json")
    return packaged if os.path.exists(packaged) else None


def set_table_path(path: Optional[str]) -> None:
    """Point dispatch at a table file (None restores the default
    resolution) and drop the cache."""
    global _table_path_override
    _table_path_override = path
    reload()


def reload() -> None:
    """Drop the cached tables (after a table file changed)."""
    with _lock:
        _table_cache.clear()


def get_table(device=None) -> Optional[DispatchTable]:
    """The table a call on ``device`` reads, or None when no file
    resolves or it is unreadable (dispatch then takes the analytic
    pick)."""
    path = table_path(device)
    if path is None:
        return None
    with _lock:
        if path not in _table_cache:
            try:
                _table_cache[path] = DispatchTable.load(path)
            except (OSError, ValueError):      # a bad table is no table
                _table_cache[path] = None
        return _table_cache[path]


def choose(op: str, key: Dict, candidates: List[str],
           fallback: Optional[str], device=None) -> Optional[str]:
    """The implementation of ``op`` at the static shape ``key`` for a call
    on ``device``: the table's winner among ``candidates`` (the eligible
    set; a winner outside it is ignored), else ``fallback`` (the caller's
    analytic pick) — always ``fallback`` in "off" mode."""
    m = mode()
    if m == "off" or not candidates:
        return fallback
    t = get_table(device)
    if t is not None:
        w = t.lookup(op, key, candidates)
        if w in candidates:
            return w
    if m == "measure" and op in MEASURABLE_INLINE and len(candidates) > 1:
        raise NotImplementedError(
            f"tuning mode 'measure' for {op!r}: the in-process "
            "measurement is not ported (ROADMAP.md, Queue A item 6)")
    return fallback


def fused_topk_candidate_impls(k: int, approx_ok: bool) -> List[str]:
    """The fused brute-force impl names eligible at ``k``:
    ``fused_<variant>:<tile>`` over :data:`FUSED_TOPK_TILES` within each
    variant's budget (exact k <= 128, fold k <= 256 and only for callers
    that opted into approximate candidates)."""
    out: List[str] = []
    if k <= 128:
        out += [f"fused_exact:{t}" for t in FUSED_TOPK_TILES]
    if approx_ok and k <= 256:
        out += [f"fused_fold:{t}" for t in FUSED_TOPK_TILES]
    return out
