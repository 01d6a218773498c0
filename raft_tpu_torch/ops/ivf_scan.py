"""IVF list scan + per-list top-k: the CUDA kernel and its plain version.

Replaces ``raft_tpu/ops/ivf_scan.py:_scan_kernel`` (``pallas_call`` at
:547): the float-storage arm, the int8 rows that its float branch widens
(:302-308, IVF-PQ's int8 caches) and the three packed storage arms
(:221-296, IVF-PQ's compressed caches), each with the exact extraction and
the binned ones (below). One step per bucket —
one query group against one inverted list: the list is found through
``bucket_list[b]``, ``dots = q . row`` with f32 accumulation, the L2 /
inner-product / cosine epilogue in min-space, columns past
``list_sizes[l]`` or with ``keep == 0`` masked, and each query's top-k
(ties to the lower list position) emitted with the **stored global ids**
read from the list's id row. Tails come back as (+inf, -1).

The reference takes the query group pre-gathered as ``qv`` [nb, G, d] and
``qaux`` [nb, G]; here the kernel gathers queries itself through
``bucket_q`` [nb, G] (-1 = empty slot) from ``queries`` [m, d] and
``qaux`` [m] — at the SIFT-1M main path the pre-gathered copy would be a
233 MB write and read per batch. Empty slots come back as (+inf, -1) (the
reference scans query 0 there; the caller never reads those slots).

Operands. ``compute_dtype`` "bf16" rounds both operands to bf16 (the
reference's bf16 compute); "f32" multiplies f32 queries by the rows
widened exactly (f32, bf16, f16, int8 or uint8 rows; f16 rows, like f32,
are rounded under "bf16"). The default follows the queries'
type, as the reference's ``qv.dtype`` does.

Residual queries (IVF-PQ, ``ivf_pq.py:2043-2062``). With ``centers``
[C, d] the staged query of a bucket on list ``l`` is
``(queries[q] - centers[l]) * scale`` and ``qaux`` is the kernel's own
``||queries[q] - centers[l]||^2`` of the unscaled f32 residual, summed
over components in order (L2 only); inner product passes ``scale`` alone
(``queries[q] * scale``). ``scale`` is one float or a per-list,
per-component tensor [C, d] (the i4 and raw caches' scales, which the
reference folds into ``qv``). The kernel builds these while it stages,
so the [nb, G, d] residual slab never exists.

Packed storage, ``[C, nw, cap]`` int32 words holding the reference's
uint32 bits, rows on the fast axis (at most one of the three):

* ``packed_i4`` (:281-296): 8 signed nibbles a word, component ``8w + j``
  is ``(word << (28 - 4j)) >> 28`` in [-8, 7]; ``d = 8 nw``. The
  dequantization scales ride in ``scale``.
* ``packed_bits`` (:256-280, :310-312, RaBitQ): 32 sign bits a word, bit
  ``j`` of word ``w`` decodes component ``32w + j`` to ``2 bit - 1``;
  ``d = 32 nw``, and queries (and centers) must be zero-padded to that
  width so the pad bits score nothing. ``row_scale`` [C, cap] (the
  estimator's ``fac``) multiplies each row's dot before the epilogue;
  ``norms`` are the true residual norms.
* ``pq_centers`` [p, 16, pq_len] f32 (``packed_pq4``, :221-255): 4-bit PQ
  codes, 8 a word, scored against the per-(query, subspace) table
  ``lut[s, v] = sum_l qv[s pq_len + l] * pq_centers[s, v, l]`` (summed
  over l in order), so ``dots = sum_s lut[s, code_s]`` summed over s in
  order; ``d = p * pq_len`` and ``nw >= p / 8``. Under bf16 compute the
  staged query, the codebook and each table entry are rounded to bf16,
  where the reference casts ``qv``, the codebook weights and ``lut_v``.

Extraction (``extract``), in min-space over a bucket's [G, cap]
distances, masked and out-of-list positions +inf. "exact" keeps each
query's top-k (ties to the lower position). The lane-binned arms of the
reference (``_extract_topk_binned`` :89, ``_extract_topk_binned_deep``
:123) fold the distances into 128 bins, a position's bin being its list
position mod 128:

* "binned" keeps one slot a bin, the bin's smallest distance (the lowest
  position among equals), and takes the k smallest slots, ties to the
  lowest position;
* "binned_deep" keeps R = 4 slots a bin, filled in position order by a
  compare-swap cascade (a newcomer takes the first level whose slot it
  beats strictly, and the slot it displaces goes on down), and takes the
  k smallest of the 128 R slots, ties to the lowest bin, then the lowest
  level.

* "fold" (``_extract_fold`` :169) keeps binned_deep's stacks at depth
  R = ``fused_topk.fold_depth(k)`` (2 to k = 128, 3 to 192, 4 to 256) and
  returns all 128 R slots unextracted, slot (r, bin) at column
  ``r 128 + bin``, id -1 where +inf: the output is [nb, G, 128 R], and
  the caller's exact merge selects (it reads the width off the output).

A true neighbour is lost where more than R (one for "binned") of a list's
top-k share a bin. :func:`eligible_extracts` and :func:`pick_extract` are
the reference's eligibility and analytic pick (``ivf_scan.py:421-436``;
the pick is never "fold"), and :func:`resolve_extract` its choice through
the dispatch table (``tuning.choose("ivf_scan_extract", ...)``, :437-441),
which an ``extract`` of None asks for.

The binned_deep arm has two CUDA bodies: the shared core's
(``csrc/scan_topk.cuh``), and one designed for Hopper
(``csrc/ivf_scan_deep.cuh``: one thread owns each (query, bin) across
128-row tiles, queries held once as tensor-core fragments, a cp.async row
ring, bf16 ``mma.sync`` dots). :func:`binned_deep_body` routes by mode:
int8, i4 and sign-bit rows with bf16 operands at d <= 128 take the Hopper
body; the rest keep the core's. Both keep what the reference's arm keeps;
the Hopper body sums each dot's f32 products in another order.

The exact and binned arms over the same three row kinds, and over f32
and bf16 rows (the IVF-Flat scan), have a Hopper body as well
(``csrc/ivf_scan_arms.cuh``), on the binned_deep body's query
preparation, ring and dots: binned keeps each (query, bin)'s best
distance and chunk in its owner's registers, exact buffers each query's
candidates under its k-th distance of the tile before and merges them
into top-k lists held by one warp. :func:`scan_body` routes by mode, k
and cap: int8 (``rot`` a multiple of 16), i4 and sign-bit rows with bf16
operands at ``rot`` <= 128, and f32 and bf16 rows with bf16 operands,
plain queries and d a multiple of 16 <= 128, take it at k <= 64 on a cap
that is a multiple of 128; the rest keep the core's. The f32 rows are
rounded to bf16 as the tensor-core operands are built, so its dots, as
the integer rows', differ from the plain version's only in the order of
the f32 sums.

The pq4 arm has two CUDA bodies as well: the core's pq4 kernel (f32
tables in shared memory, one lookup and add per (query, row, subspace)),
and one designed for Hopper (``csrc/ivf_scan_pq4.cuh``: the reference's
one-hot contraction, ``dots += lut_v @ (codes == v)``, as bf16 ``wgmma``
products of the one-hot codes and the tables, K the 16 code values, 32
queries a block, the bf16 tables staged once). :func:`pq4_body` routes by
operand type, arm and shared memory: bf16 operands at the exact, binned
and binned_deep arms take the Hopper body where its block fits
(:func:`pq4_smem_bytes`); f32 operands, the fold arms and wider tables
keep the core's. The Hopper body adds the same table entries in the same
order, but the tensor cores accumulate in f32 without rounding to
nearest, so it is bit for bit the plain version only where every partial
sum is exact.

On a CUDA tensor :func:`ivf_list_scan_topk` launches
``csrc/ivf_list_scan_topk.cu`` or raises; on a CPU tensor it runs
:func:`ivf_list_scan_topk_plain`; nothing else. Its ``launches`` counts
every launch and ``by_body`` splits them by body ("core", "hopper" for
binned_deep, "hopper_exact", "hopper_binned", "pq4_hopper").
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from raft_tpu_torch.neighbors.common import merge_topk
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops.fused_topk import COSINE, IP, K_MAX, L2, _epilogue, \
    fold_depth, fold_lane_stacks
from raft_tpu_torch.utils.precision import dist_dot, round_bf16

_PLAIN_BUCKETS = 64     # buckets per plain-version batch
# the kernel's storage_kind: dense rows by dtype, packed words by arm
I8, I4, BITS, PQ4, F16, U8 = 2, 3, 4, 5, 6, 7
_STORAGE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: I8,
                 torch.float16: F16, torch.uint8: U8}
_DENSE = frozenset(_STORAGE_KIND.values())
# the kernel's extraction arm by name (fold at depth R is 3 + R - 2), and
# the binned arms' slots per bin
EXTRACTS = {"exact": 0, "binned": 1, "binned_deep": 2, "fold": 3}
_BIN_DEPTH = {"binned": 1, "binned_deep": 4}
_BINS = 128
# the extract code of binned_deep through the Hopper body
HOPPER_DEEP = 6
# a block's shared memory on the H100, and the Hopper body's use of it:
# 64 queries x 128 bins x 24 B of slots, 2 ring stages, 512 B of query ids
# and qaux (csrc/ivf_scan_deep.cuh)
SMEM_LIMIT = 232_448
_DEEP_SLOTS, _DEEP_STAGES, _DEEP_STATIC = 64 * 128 * 24, 2, 512
# the extract code of the exact arm through the pq4 Hopper body (binned 8,
# binned_deep 9), and that body's block (csrc/ivf_scan_pq4.cuh): 32
# queries, 256-row tiles in 2 ring stages, the exact arm's distance tile
# rows of 260 floats (k > 32), 256 B of query ids and qaux
PQ4_HOPPER = 7
_PQ4_Q, _PQ4_T, _PQ4_STAGES, _PQ4_DIST_LD, _PQ4_STATIC = 32, 256, 2, 260, 256
# the extract codes of the exact and binned arms through the Hopper arms'
# body, the largest k it takes, and its exact arm's buffer a 64 queries
# (blocks of 128 take twice): 64 queries x 128 rows of an f32 distance and
# a row byte, 64 counts and thresholds (its lists add 64 k (f32, int32))
# (csrc/ivf_scan_arms.cuh)
HOPPER_EXACT, HOPPER_BINNED = 10, 11
ARMS_K_MAX = 64
_ARMS_BUFFER = 64 * 128 * 5 + 64 * 8
# the dense float kinds the arms' body takes besides the binned_deep
# body's (f32, bf16), and their bytes an element
_FLOAT_ROWS = {0: 4, 1: 2}

# the per-list recall budget the binned arm is judged against when the
# caller does not say (the SearchParams default)
DEFAULT_RECALL_TARGET = 0.95


def binned_loss_fits(k: int,
                     recall_target: float = DEFAULT_RECALL_TARGET) -> bool:
    """The one-slot binning's loss model (``ivf_scan.py:48``): a bin keeps
    one candidate, so a true top-k entry is lost whenever a better one
    shares its bin — an expected lost fraction of ~(k - 1) / 256. A
    ``recall_target`` of 0 or less always fits."""
    rt = float(recall_target)
    return rt <= 0.0 or (k - 1) / 256.0 <= max(0.0, 1.0 - rt)


def binned_k_cap(recall_target: float = DEFAULT_RECALL_TARGET) -> int:
    """The largest k the loss model admits at ``recall_target`` (at most
    64, the one-slot arm's own limit)."""
    k = 64
    while k > 1 and not binned_loss_fits(k, recall_target):
        k -= 1
    return k


def eligible_extracts(k: int, cap: int, approx: bool = True,
                      recall_target: float = DEFAULT_RECALL_TARGET) -> list:
    """The extraction arms allowed for ``k`` of a list capacity ``cap``
    (``ivf_scan.py:421-432``): the binned arms and fold need ``approx``, a
    cap that is a multiple of 128 over 128, and k <= 256; the one-slot arm
    also k <= 64 within the loss model."""
    binned_ok = approx and cap % _BINS == 0 and cap > _BINS
    eligible = ["exact"]
    if binned_ok and k <= 64 and binned_loss_fits(k, recall_target):
        eligible.append("binned")
    if binned_ok and k <= 256:
        eligible += ["binned_deep", "fold"]
    return eligible


def pick_extract(k: int, cap: int, approx: bool = True,
                 recall_target: float = DEFAULT_RECALL_TARGET) -> str:
    """The reference's analytic pick (``ivf_scan.py:433-436``): binned
    wherever it is eligible, else binned_deep, else exact."""
    eligible = eligible_extracts(k, cap, approx, recall_target)
    return ("binned" if "binned" in eligible
            else "binned_deep" if "binned_deep" in eligible else "exact")


def resolve_extract(k: int, cap: int, G: int, approx: bool = True,
                    recall_target: float = DEFAULT_RECALL_TARGET,
                    device=None) -> str:
    """The reference's arm for a scan of ``k`` a list of capacity ``cap``
    in query groups of ``G`` (``ivf_scan.py:419-441``): the dispatch
    table's ``ivf_scan_extract`` winner among :func:`eligible_extracts` at
    the key {cap, k, g}, else :func:`pick_extract`, for a call on
    ``device``."""
    from raft_tpu_torch import tuning

    return tuning.choose(
        "ivf_scan_extract", {"cap": int(cap), "k": int(k), "g": int(G)},
        eligible_extracts(k, cap, approx, recall_target),
        pick_extract(k, cap, approx, recall_target), device=device)


def binned_deep_body(kind: int, round_ops: bool, rot: int) -> str:
    """The body a binned_deep launch takes: "hopper"
    (``csrc/ivf_scan_deep.cuh``) for int8 rows (``rot`` a multiple of 16),
    packed i4 and packed sign bits, with bf16 operands (``round_ops``) and
    the kernel's width ``rot`` <= 128 (the sign-bit arm's padded width);
    else "core" (the shared core's binned_deep: f32 and bf16 rows, f32
    operands, wider rows, the pq4 kernel)."""
    if not round_ops or kind not in (I8, I4, BITS) or rot > 128:
        return "core"
    if kind == I8 and rot % 16:
        return "core"
    return "hopper"


def scan_body(kind: int, round_ops: bool, rot: int, k: int, extract: str,
              cap: int, plain_queries: bool = True) -> str:
    """The body a launch over rows of storage ``kind`` at the kernel's
    width ``rot`` takes for ``k`` of a list capacity ``cap`` at
    ``extract``: where :func:`binned_deep_body` gives "hopper" (int8 rows
    at ``rot`` a multiple of 16, i4 and sign bits, bf16 operands, ``rot``
    <= 128), binned_deep takes "hopper" (``csrc/ivf_scan_deep.cuh``), and
    the exact and binned arms "hopper_exact" and "hopper_binned"
    (``csrc/ivf_scan_arms.cuh``) at k <= 64 on a cap that is a multiple
    of 128; so do the exact and binned arms over f32 and bf16 rows (kinds
    0 and 1) with bf16 operands, ``plain_queries`` (no centers, scale 1)
    and ``rot`` a multiple of 16 <= 128. Else "core" (the fold arms,
    binned_deep over float rows, larger k, other caps, residual or scaled
    queries over float rows, f16 and uint8 rows and f32 operands; the pq4
    kind routes by :func:`pq4_body`)."""
    if extract not in ("exact", "binned", "binned_deep"):
        return "core"
    if kind in _FLOAT_ROWS:
        if extract == "binned_deep" or not (round_ops and plain_queries) \
                or rot % 16 or rot > 128:
            return "core"
    elif binned_deep_body(kind, round_ops, rot) == "core":
        return "core"
    elif extract == "binned_deep":
        return "hopper"
    if k > ARMS_K_MAX or cap % _BINS:
        return "core"
    return "hopper_" + extract


def _ring_stage_bytes(kind: int, rot: int, n_sides: int) -> int:
    """One ring stage of the Hopper bodies over ``kind``'s rows: a 128-row
    tile (int8 128 rot B, f32 512 rot, bf16 256 rot, i4 64 rot, sign words
    16 rot) and 512 B for each side array."""
    rows = 128 * (rot if kind == I8 else _FLOAT_ROWS[kind] * rot
                  if kind in _FLOAT_ROWS else 4 * (rot // 8) if kind == I4
                  else 4 * -(-rot // 32))
    return rows + 512 * n_sides


def _check_hopper_kind(kind: int, body: str, kinds=(I8, I4, BITS)) -> None:
    if kind not in kinds:
        raise ValueError(f"the Hopper {body} body takes storage kinds "
                         f"{sorted(kinds)}, not {kind}")


def _arms_block_bytes(kind: int, rot: int, k: int, exact: bool, q: int,
                      n_sides: int) -> int:
    """Shared memory of an arms' body block of ``q`` queries (dynamic and
    static): the prepared queries (q / 16 x 512 B a 16-dim k-step), two
    ring stages (f32 rows of the exact arm at 128 queries staged as bf16),
    then the exact arm's buffer (``_ARMS_BUFFER`` a 64 queries) and q
    lists of k (f32, int32), or for binned at least q x 128 slots of 6
    B; and 8 B a query of ids and qaux."""
    ksteps = (rot // 16 if kind == I8 or kind in _FLOAT_ROWS
              else 2 * -(-(rot // 8) // 4) if kind == I4
              else 2 * -(-rot // 32))
    stage_kind = 1 if kind == 0 and exact and q > 64 else kind
    scan = 32 * q * ksteps + _DEEP_STAGES * _ring_stage_bytes(
        stage_kind, rot, n_sides)
    return (scan + _ARMS_BUFFER * q // 64 + q * k * 8 if exact
            else max(scan, q * 128 * 6)) + 8 * q


def arms_queries(kind: int, rot: int, k: int, extract: str,
                 norms: bool = True, keep: bool = True,
                 row_scale: bool = False) -> int:
    """Queries a block of the arms' body's launch (``arm_queries`` in
    ``csrc/ivf_scan_arms.cuh``): 128 for f32 rows and for the bf16 rows'
    exact arm where that block fits a block's shared memory (the exact
    arm to k 47 with norms and keep), else 64."""
    if kind not in _FLOAT_ROWS or (kind == 1 and extract != "exact"):
        return 64
    n_sides = int(norms) + int(keep) + int(row_scale)
    fits = _arms_block_bytes(kind, rot, k, extract == "exact", 128,
                             n_sides) <= SMEM_LIMIT
    return 128 if fits else 64


def arms_smem_bytes(kind: int, rot: int, k: int, extract: str,
                    norms: bool = True, keep: bool = True,
                    row_scale: bool = False) -> int:
    """Shared memory of one block of the Hopper arms' body (dynamic and
    static) for rows of ``kind`` (int8, i4, sign bits, f32 or bf16) at
    width ``rot``, ``k`` and ``extract`` ("exact" or "binned") with the
    side arrays named, at the block :func:`arms_queries` picks
    (``_arms_block_bytes``). Two blocks of 64 queries share an SM where
    twice this fits its 228 KB. Raises where it exceeds a block's
    232,448 B or the body does not take the kind, the width (int8, f32
    and bf16 rows: a multiple of 16 <= 128) or the arm."""
    _check_hopper_kind(kind, "arms'", (0, 1, I8, I4, BITS))
    if extract not in ("exact", "binned"):
        raise ValueError(f"the Hopper arms' body takes the exact and binned "
                         f"arms, not {extract!r}")
    if kind in _FLOAT_ROWS and (rot % 16 or rot > 128):
        raise ValueError(f"the Hopper arms' body takes f32 and bf16 rows at "
                         f"a width that is a multiple of 16 <= 128, not "
                         f"{rot}")
    q = arms_queries(kind, rot, k, extract, norms, keep, row_scale)
    total = _arms_block_bytes(kind, rot, k, extract == "exact", q,
                              int(norms) + int(keep) + int(row_scale))
    if total > SMEM_LIMIT:
        raise ValueError(f"the Hopper arms' body needs {total} B of shared "
                         f"memory at rot={rot}, more than a block's "
                         f"{SMEM_LIMIT}")
    return total


def deep_smem_bytes(kind: int, rot: int, norms: bool = True,
                    keep: bool = True, row_scale: bool = False) -> int:
    """Shared memory of one Hopper-body block (dynamic and static) for rows
    of ``kind`` at width ``rot`` with the side arrays named: the slots,
    two ring stages of a 128-row tile (int8 128 rot B, i4 64 rot, sign
    words 16 rot) and 512 B for each side array, and the query ids and
    qaux. Raises where it exceeds a block's 232,448 B or the body does not
    take the kind."""
    _check_hopper_kind(kind, "binned_deep")
    stage = _ring_stage_bytes(kind, rot,
                              int(norms) + int(keep) + int(row_scale))
    total = _DEEP_SLOTS + _DEEP_STAGES * stage + _DEEP_STATIC
    if total > SMEM_LIMIT:
        raise ValueError(f"the Hopper binned_deep body needs {total} B of "
                         f"shared memory at rot={rot}, more than a block's "
                         f"{SMEM_LIMIT}")
    return total


def _pq4_block_bytes(p: int, k: int, extract: str, norms: bool = True,
                     keep: bool = True) -> Optional[int]:
    """:func:`pq4_smem_bytes`' sum, or None for an arm the body does not
    take."""
    arms = {"exact": (_PQ4_Q * _PQ4_T * 8 + _PQ4_Q * 8 if k <= 32 else
                      _PQ4_Q * _PQ4_DIST_LD * 4 + _PQ4_Q * k * 8),
            "binned": _PQ4_Q * _BINS * 6,
            "binned_deep": _PQ4_Q * _BINS * 24}
    if extract not in arms:
        return None
    stage = (-(-p // 8) + int(norms) + int(keep)) * _PQ4_T * 4
    return (_PQ4_Q * p * 32 + _PQ4_STAGES * stage + arms[extract]
            + _PQ4_STATIC)


def pq4_smem_bytes(p: int, k: int, extract: str, norms: bool = True,
                   keep: bool = True) -> int:
    """Shared memory of one pq4 Hopper-body block (dynamic and static) for
    ``p`` subspaces at ``k`` and ``extract``: the bf16 tables (32 queries
    x p x 16 x 2 B), two ring stages of 256 rows of ceil(p / 8) code words
    and a word for each side array named, the arm's region (exact at k <=
    32: 32 x 256 (f32, int32) buffered candidates and 32 counts and
    thresholds; at k > 32: a 32 x 260 f32 distance tile and 32 k (f32,
    int32) lists; binned: 32 x 128 slots of 6 B; binned_deep: 32 x 128 x
    24 B) and 256 B of query ids and qaux. Raises where it exceeds a
    block's 232,448 B or the body does not take the arm."""
    total = _pq4_block_bytes(p, k, extract, norms, keep)
    if total is None:
        raise ValueError(f"the pq4 Hopper body takes the exact, binned and "
                         f"binned_deep arms, not {extract!r}")
    if total > SMEM_LIMIT:
        raise ValueError(f"the pq4 Hopper body needs {total} B of shared "
                         f"memory at p={p}, k={k}, {extract}, more than a "
                         f"block's {SMEM_LIMIT}")
    return total


def pq4_body(round_ops: bool, p: int, pl: int, k: int, extract: str) -> str:
    """The body a pq4 launch of ``p`` subspaces of ``pl`` components takes
    at ``k`` and ``extract``: "hopper" (``csrc/ivf_scan_pq4.cuh``) for bf16
    operands (``round_ops``) at the exact, binned and binned_deep arms
    where its block fits a block's shared memory with norms and keep
    (:func:`pq4_smem_bytes`; the sum does not depend on ``pl``, since each
    table entry takes 2 B whatever its sum's length); else "core" (f32
    operands, the fold arms, wider tables)."""
    if not round_ops or p < 1 or pl < 1:
        return "core"
    total = _pq4_block_bytes(p, k, extract)
    return "hopper" if total is not None and total <= SMEM_LIMIT else "core"


def extract_code(extract: str, k: int, body: str = "core") -> int:
    """The C entry's extract code: the arm's, at the fold's depth;
    ``HOPPER_DEEP`` for binned_deep through the Hopper body;
    ``HOPPER_EXACT`` and ``HOPPER_BINNED`` for the Hopper arms' body; or
    ``PQ4_HOPPER`` plus the arm's for the pq4 Hopper body."""
    if extract == "binned_deep" and body == "hopper":
        return HOPPER_DEEP
    if body == "hopper_exact":
        return HOPPER_EXACT
    if body == "hopper_binned":
        return HOPPER_BINNED
    if body == "pq4_hopper":
        return PQ4_HOPPER + EXTRACTS[extract]
    return EXTRACTS[extract] + (fold_depth(k) - 2 if extract == "fold"
                                else 0)


def out_width(k: int, extract: str) -> int:
    """Columns a bucket's query row of the output has: k, or 128 R for
    fold."""
    return 128 * fold_depth(k) if extract == "fold" else int(k)


def storage_kind(storage: torch.Tensor, packed_i4: bool = False,
                 packed_bits: bool = False, pq_centers=None) -> int:
    """The kernel's storage kind: dense f32 / bf16 / int8 / f16 / uint8
    rows (0, 1, I8, F16, U8), or the packed arm I4 / BITS / PQ4; raises on
    an arm clash or a bad type."""
    n_arms = int(packed_i4) + int(packed_bits) + int(pq_centers is not None)
    if n_arms > 1:
        raise ValueError("packed_i4, packed_bits and pq_centers are "
                         "mutually exclusive")
    if n_arms:
        if storage.dim() != 3 or storage.dtype != torch.int32:
            raise ValueError(f"packed storage must be [C, nw, cap] int32 "
                             f"words, got {tuple(storage.shape)} "
                             f"{storage.dtype}")
        return I4 if packed_i4 else BITS if packed_bits else PQ4
    if storage.dim() != 3:
        raise ValueError(f"storage must be [C, cap, d], got "
                         f"{tuple(storage.shape)}")
    if storage.dtype not in _STORAGE_KIND:
        raise ValueError(f"storage must be f32, bf16 or int8 (or IVF-Flat's "
                         f"f16 and uint8) rows, got {storage.dtype}")
    return _STORAGE_KIND[storage.dtype]


def _geometry(storage, kind, pq_centers) -> Tuple[int, int, int]:
    """(C, cap, d): d is the width of the queries the storage is scored
    against."""
    if kind in _DENSE:
        return tuple(storage.shape)
    C, nw, cap = storage.shape
    if kind == I4:
        return C, cap, nw * 8
    if kind == BITS:
        return C, cap, nw * 32
    if pq_centers.dim() != 3 or pq_centers.shape[1] != 16:
        raise ValueError(f"pq_centers must be [p, 16, pq_len] (4-bit "
                         f"codes), got {tuple(pq_centers.shape)}")
    p, _, pl = pq_centers.shape
    if p > nw * 8:
        raise ValueError(f"pq_centers has {p} subspaces, more than the "
                         f"{nw * 8} codes a row packs")
    return C, cap, p * pl


def _check(storage, indices, list_sizes, bucket_list, bucket_q, queries, k,
           metric_kind, qaux, norms, centers, compute_dtype, k_max, scale,
           kind, pq_centers, row_scale, extract):
    C, cap, d = _geometry(storage, kind, pq_centers)
    if extract not in EXTRACTS:
        raise ValueError(f"extract must be one of {sorted(EXTRACTS)}, got "
                         f"{extract!r}")
    # the structural rule (a recall target of 0 admits any loss)
    if extract not in eligible_extracts(k, cap, True, 0.0):
        raise ValueError(f"extract={extract!r} not eligible at k={k}, "
                         f"cap={cap} (binned arms and fold: cap a multiple "
                         f"of 128 over 128; k <= 64 binned, <= 256 "
                         f"binned_deep and fold)")
    if tuple(indices.shape) != (C, cap) or tuple(list_sizes.shape) != (C,):
        raise ValueError("indices must be [C, cap] and list_sizes [C]")
    if bucket_q.dim() != 2 or bucket_q.shape[0] != bucket_list.shape[0]:
        raise ValueError("bucket_q must be [nb, G] with nb = len(bucket_list)")
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"queries must be [m, {d}], got "
                         f"{tuple(queries.shape)}")
    if metric_kind not in (L2, IP, COSINE):
        raise ValueError(f"metric_kind must be L2|IP|COSINE, got {metric_kind}")
    if centers is not None:
        if metric_kind != L2:
            raise ValueError("centers (residual queries) are for L2 only; "
                             "inner product passes scale alone")
        if tuple(centers.shape) != (C, d):
            raise ValueError(f"centers must be [{C}, {d}], got "
                             f"{tuple(centers.shape)}")
    if isinstance(scale, torch.Tensor) and tuple(scale.shape) != (C, d):
        raise ValueError(f"a per-list scale must be [{C}, {d}], got "
                         f"{tuple(scale.shape)}")
    if kind in (F16, U8) and (centers is not None or isinstance(
            scale, torch.Tensor) or scale != 1.0):
        raise ValueError("f16 and uint8 rows are scanned with plain queries "
                         "(no centers, scale 1)")
    if kind == PQ4 and (isinstance(scale, torch.Tensor) or scale != 1.0):
        raise ValueError("the pq4 arm is scale-free (its table holds the "
                         "codebook)")
    if row_scale is not None:
        if kind != BITS:
            raise ValueError("row_scale belongs to the packed_bits arm")
        if tuple(row_scale.shape) != (C, cap):
            raise ValueError(f"row_scale must be [{C}, {cap}], got "
                             f"{tuple(row_scale.shape)}")
    if metric_kind == COSINE and kind not in _DENSE:
        raise ValueError("the packed arms score L2 or inner product")
    if metric_kind != IP and (norms is None or
                              (qaux is None and centers is None)):
        raise ValueError("L2 and cosine need norms [C, cap] and qaux [m] "
                         "(or centers)")
    if compute_dtype not in ("f32", "bf16"):
        raise ValueError(f"compute_dtype must be f32|bf16, got "
                         f"{compute_dtype!r}")
    if not 0 < k <= min(k_max, cap):
        raise ValueError(f"k={k} out of range (1..min({k_max}, cap={cap}))")


def _compute_dtype(queries: torch.Tensor, compute_dtype) -> str:
    if compute_dtype is None:
        return "bf16" if queries.dtype == torch.bfloat16 else "f32"
    return str(compute_dtype)


def ivf_list_scan_topk(storage: torch.Tensor, indices: torch.Tensor,
                       list_sizes: torch.Tensor, bucket_list: torch.Tensor,
                       bucket_q: torch.Tensor, queries: torch.Tensor,
                       qaux: Optional[torch.Tensor] = None,
                       norms: Optional[torch.Tensor] = None,
                       keep: Optional[torch.Tensor] = None, *, k: int,
                       metric_kind: int,
                       compute_dtype: Optional[str] = None,
                       centers: Optional[torch.Tensor] = None,
                       scale: Union[float, torch.Tensor] = 1.0,
                       packed_i4: bool = False, packed_bits: bool = False,
                       pq_centers: Optional[torch.Tensor] = None,
                       row_scale: Optional[torch.Tensor] = None,
                       extract: Optional[str] = "exact",
                       approx: bool = True,
                       recall_target: float = DEFAULT_RECALL_TARGET,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan each bucket's list against its query group; returns
    (out_d [nb, G, w] f32 min-space, out_i [nb, G, w] int32 global ids),
    w = k, or 128 R for the fold arm.

    ``storage`` [C, cap, d] f32, bf16, f16, int8 or uint8 (f16 and uint8
    with plain queries: no ``centers``, ``scale`` 1), or [C, nw, cap] int32
    packed words; ``indices`` [C, cap] int32; ``list_sizes`` [C];
    ``bucket_list`` [nb]; ``bucket_q`` [nb, G]; ``queries`` [m, d];
    ``qaux`` [m] (||q||^2 for L2, ||q|| for cosine; None for inner product
    and with ``centers``) and ``norms`` [C, cap] (||x||^2, None for inner
    product); ``keep`` [C, cap] (nonzero = eligible) or None;
    ``compute_dtype``, ``centers``, ``scale`` and the packed arms
    (``packed_i4``, ``packed_bits`` with ``row_scale``, ``pq_centers``)
    and ``extract`` ("exact", "binned", "binned_deep", "fold") as in the
    module docstring; an ``extract`` of None takes
    :func:`resolve_extract`'s arm at ``approx`` and ``recall_target``."""
    cd = _compute_dtype(queries, compute_dtype)
    kind = storage_kind(storage, packed_i4, packed_bits, pq_centers)
    if extract is None:
        extract = resolve_extract(k, _geometry(storage, kind, pq_centers)[1],
                                  bucket_q.shape[1], approx, recall_target,
                                  storage.device)
    _check(storage, indices, list_sizes, bucket_list, bucket_q, queries, k,
           metric_kind, qaux, norms, centers, cd, K_MAX, scale, kind,
           pq_centers, row_scale, extract)
    if storage.device.type == "cpu":
        return ivf_list_scan_topk_plain(
            storage, indices, list_sizes, bucket_list, bucket_q, queries,
            qaux, norms, keep, k=k, metric_kind=metric_kind,
            compute_dtype=cd, centers=centers, scale=scale,
            packed_i4=packed_i4, packed_bits=packed_bits,
            pq_centers=pq_centers, row_scale=row_scale, extract=extract)
    if not storage.is_cuda:
        raise ValueError(f"ivf_list_scan_topk takes CPU or CUDA tensors, got "
                         f"{storage.device}")
    return _launch(storage, kind, indices, list_sizes, bucket_list, bucket_q,
                   queries, qaux, norms, keep, int(k), int(metric_kind),
                   cd == "bf16", centers, scale, pq_centers, row_scale,
                   extract)


ivf_list_scan_topk.launches = 0
ivf_list_scan_topk.by_body = {"core": 0, "hopper": 0, "hopper_exact": 0,
                              "hopper_binned": 0, "pq4_hopper": 0}


def _launch(storage, kind, indices, list_sizes, bucket_list, bucket_q,
            queries, qaux, norms, keep, k, metric_kind, bf16, centers, scale,
            pq_centers, row_scale, extract):
    dev = storage.device
    C, cap, d = _geometry(storage, kind, pq_centers)
    nb, G = bucket_q.shape

    def i32(t):
        return None if t is None else t.to(device=dev,
                                           dtype=torch.int32).contiguous()

    def f32(t):
        return None if t is None else t.to(device=dev,
                                           dtype=torch.float32).contiguous()

    st = storage.contiguous()
    q32 = f32(queries)
    vec = isinstance(scale, torch.Tensor)
    scalar = 1.0 if vec else float(scale)
    if bf16 and centers is None and not vec and kind != PQ4 and \
            ctypes.c_float(scalar).value == 1.0:
        # plain queries are rounded once here; the kernel rounds only the
        # residual or scaled queries it builds while staging
        q32 = round_bf16(q32)
    p = pl = nw = 0
    if kind not in _DENSE:
        nw = st.shape[1]
    if kind == PQ4:
        # a p or k whose tables (or bins) overflow a block's shared memory
        # comes back from the launch as a CUDA error
        p, _, pl = pq_centers.shape
    args = dict(ix=i32(indices), ls=i32(list_sizes), bl=i32(bucket_list),
                bq=i32(bucket_q), qa=None if centers is not None
                else f32(qaux), xn=f32(norms), kp=i32(keep),
                ct=f32(centers), sv=f32(scale) if vec else None,
                rs=f32(row_scale), pc=f32(pq_centers))
    w = out_width(k, extract)
    if kind == PQ4:
        body = ("pq4_hopper" if pq4_body(bf16, p, pl, k, extract) == "hopper"
                else "core")
    else:
        body = scan_body(kind, bf16, d, k, extract, cap,
                         centers is None and not vec
                         and ctypes.c_float(scalar).value == 1.0)
    if body != "core":
        # the launch returns its CUDA error where the budget is exceeded
        st = _build.aligned(st)
        args.update({key: _build.aligned(args[key])
                     for key in ("xn", "kp", "rs")})
    code = extract_code(extract, k, body)
    out_d = torch.empty((nb, G, w), dtype=torch.float32, device=dev)
    out_i = torch.empty((nb, G, w), dtype=torch.int32, device=dev)

    lib = _build.load("ivf_list_scan_topk")
    fn = lib.ivf_list_scan_topk
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 9 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    ptr = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(st), kind, ptr(args["ix"]), ptr(args["ls"]),
                ptr(args["bl"]), ptr(args["bq"]), ptr(q32), ptr(args["qa"]),
                ptr(args["xn"]), ptr(args["kp"]), ptr(args["ct"]), scalar,
                ptr(args["sv"]), ptr(args["rs"]), ptr(args["pc"]), cap, d,
                nw, p, pl, nb, G, k, metric_kind, int(bf16), code,
                ptr(out_d), ptr(out_i), stream)
    _build.check(lib, "ivf_list_scan_topk", rc)
    # counted on the module attribute, which a stand-in may replace
    counted = ivf_list_scan_topk
    counted.launches += 1
    by_body = getattr(counted, "by_body", None)
    if by_body is not None:
        by_body[body] = by_body.get(body, 0) + 1
    return out_d, out_i


def sq_norms_in_order(r: torch.Tensor) -> torch.Tensor:
    """``sum(r * r, -1)`` in f32, component 0 first, each product and each
    sum rounded once — the kernel's order for residual qaux."""
    acc = torch.zeros(r.shape[:-1], dtype=torch.float32, device=r.device)
    for c in range(r.shape[-1]):
        rc = r[..., c]
        acc = acc + rc * rc
    return acc


def unpack_fields(words, n: int, bits: int,
                  signed: bool = False) -> torch.Tensor:
    """[..., nw] int32 words -> [..., n] int32 fields of ``bits`` bits,
    ``32 // bits`` a word from the low end: field ``j`` is in word ``j //
    (32 // bits)``. ``signed`` sign-extends them, ``(word << (32 - bits -
    shift)) >> (32 - bits)`` (the i4 arm's decode). The one decoder of
    the packed caches: PQ codes, signed nibbles and sign bits."""
    w = torch.as_tensor(words).to(torch.int32)
    cpw = 32 // bits
    j = torch.arange(n, device=w.device)
    sel = w.index_select(-1, j // cpw)
    shift = ((j % cpw) * bits).to(torch.int32)
    if signed:
        return (sel << (32 - bits - shift)) >> (32 - bits)
    return (sel >> shift) & ((1 << bits) - 1)


def _pq4_dots(qv: torch.Tensor, codes: torch.Tensor, pq_centers,
              bf16: bool) -> torch.Tensor:
    """The pq4 arm's dots [bb, G, cap]: each (query, subspace) table
    summed over pq_len in order and rounded as the operands are, then the
    rows' table entries summed over subspaces in order."""
    bb, G, _ = qv.shape
    p, _, pl = pq_centers.shape
    pqc = pq_centers.float()
    if bf16:
        pqc = round_bf16(pqc)
    q4 = qv.reshape(bb, G, p, 1, pl)
    lut = torch.zeros((bb, G, p, 16), dtype=torch.float32, device=qv.device)
    for l in range(pl):
        lut = lut + q4[..., l] * pqc[:, :, l]
    if bf16:
        lut = round_bf16(lut)
    cap = codes.shape[1]
    dots = torch.zeros((bb, G, cap), dtype=torch.float32, device=qv.device)
    for s in range(p):
        idx = codes[:, None, :, s].long().expand(bb, G, cap)
        dots = dots + torch.gather(lut[:, :, s, :], 2, idx)
    return dots


def ivf_list_scan_topk_plain(storage: torch.Tensor, indices: torch.Tensor,
                             list_sizes: torch.Tensor,
                             bucket_list: torch.Tensor,
                             bucket_q: torch.Tensor, queries: torch.Tensor,
                             qaux: Optional[torch.Tensor] = None,
                             norms: Optional[torch.Tensor] = None,
                             keep: Optional[torch.Tensor] = None, *, k: int,
                             metric_kind: int,
                             compute_dtype: Optional[str] = None,
                             centers: Optional[torch.Tensor] = None,
                             scale: Union[float, torch.Tensor] = 1.0,
                             packed_i4: bool = False,
                             packed_bits: bool = False,
                             pq_centers: Optional[torch.Tensor] = None,
                             row_scale: Optional[torch.Tensor] = None,
                             extract: Optional[str] = "exact",
                             approx: bool = True,
                             recall_target: float = DEFAULT_RECALL_TARGET,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: batches of buckets gather
    their list blocks (decoding packed words) and queries (subtracting,
    scaling and rounding as the kernel stages them), take a batched f32
    product (the pq4 arm: table lookups summed in the kernel's order),
    mask, and keep each query's top-k with a stable sort (ties to the
    lower list position), or its binned top-k (:func:`binned_topk`), or
    its fold slots (:func:`fold_topk`). The exact arm keeps any k up to
    the capacity (the kernel: 256)."""
    cd = _compute_dtype(queries, compute_dtype)
    kind = storage_kind(storage, packed_i4, packed_bits, pq_centers)
    if extract is None:
        extract = resolve_extract(k, _geometry(storage, kind, pq_centers)[1],
                                  bucket_q.shape[1], approx, recall_target,
                                  storage.device)
    _check(storage, indices, list_sizes, bucket_list, bucket_q, queries, k,
           metric_kind, qaux, norms, centers, cd, indices.shape[1], scale,
           kind, pq_centers, row_scale, extract)
    cap = indices.shape[1]
    nb, G = bucket_q.shape
    dev = storage.device
    bf16 = cd == "bf16"
    q32 = queries.to(dev).float()
    vec = isinstance(scale, torch.Tensor)
    sc = (scale.to(dev).float() if vec
          else torch.tensor(float(scale), dtype=torch.float32, device=dev))
    col = torch.arange(cap, device=dev)
    out_d, out_i = [], []
    for b0 in range(0, nb, _PLAIN_BUCKETS):
        bl = bucket_list[b0:b0 + _PLAIN_BUCKETS].long()
        bq = bucket_q[b0:b0 + _PLAIN_BUCKETS].long()
        qsafe = bq.clamp_min(0)
        qv = q32[qsafe]                                   # [bb, G, d]
        qa = None
        if centers is not None:
            qv = qv - centers.to(dev).float()[bl][:, None, :]
            qa = sq_norms_in_order(qv)[:, :, None]        # [bb, G, 1]
        elif metric_kind != IP:
            qa = qaux.to(dev).float()[qsafe][:, :, None]
        qv = qv * (sc[bl][:, None, :] if vec else sc)
        if bf16:
            qv = round_bf16(qv)
        if kind == PQ4:
            codes = unpack_fields(storage[bl].transpose(1, 2),
                                  pq_centers.shape[0], 4)     # [bb, cap, p]
            dots = _pq4_dots(qv, codes, pq_centers.to(dev), bf16)
        else:
            if kind == I4:
                blk = unpack_fields(storage[bl].transpose(1, 2), qv.shape[2],
                                    4, signed=True).float()
            elif kind == BITS:
                blk = (2 * unpack_fields(storage[bl].transpose(1, 2),
                                         qv.shape[2], 1) - 1).float()
            else:
                blk = storage[bl].float()                 # [bb, cap, d]
                if bf16:
                    blk = round_bf16(blk)
            dots = dist_dot(qv, blk.transpose(1, 2))      # [bb, G, cap]
        if row_scale is not None:
            dots = dots * row_scale.to(dev).float()[bl][:, None, :]
        xn = None if metric_kind == IP else norms[bl].float()[:, None, :]
        dist = _epilogue(dots, metric_kind, qa, xn)
        valid = col[None, :] < list_sizes[bl].long()[:, None]   # [bb, cap]
        if keep is not None:
            valid = valid & (keep[bl] > 0)
        valid = valid[:, None, :] & (bq >= 0)[:, :, None]
        dist = torch.where(valid, dist, float("inf"))
        if extract == "exact":
            ids = indices[bl].to(torch.int32)[:, None, :].expand(-1, G, -1)
            d_k, i_k = merge_topk(dist, ids, k, select_min=True)
        elif extract == "fold":
            d_k, i_k = fold_topk(dist, indices[bl], k)
        else:
            d_k, i_k = binned_topk(dist, indices[bl], k, extract)
        out_d.append(d_k)
        out_i.append(torch.where(torch.isinf(d_k), -1, i_k))
    return torch.cat(out_d), torch.cat(out_i).to(torch.int32)


def binned_topk(dist: torch.Tensor, ids: torch.Tensor, k: int,
                extract: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The binned arms' extraction over min-space distances [bb, G, cap]
    (cap a multiple of 128; +inf where masked) with the lists' ids
    [bb, cap]: (distances [bb, G, k], ids, -1 where +inf).

    Each bin keeps a stack of R slots (one for "binned"), filled 128
    positions at a time in list order by the reference's compare-swap
    cascade with a strict ``<``: a newcomer enters at the first level
    whose slot it beats and the slot it displaces goes on down. Equal
    distances therefore do not stay in position order — a displaced entry
    passes an equal one below it — so a stable sort of each bin would keep
    other entries than the kernels do. "binned" takes its k smallest slots
    by (distance, position), "binned_deep" its k smallest of the 128 R by
    (distance, bin, level)."""
    bb, G, cap = dist.shape
    R = _BIN_DEPTH[extract]
    pos = torch.arange(cap, device=dist.device).expand(bb, G, cap)
    sd, sp = fold_lane_stacks(dist, pos, R)            # [bb, G, R, 128]
    # slots in (bin, level) order, unfilled ones at position 0; "binned"
    # reorders them by position so that the stable sort below breaks its
    # ties by position
    sd = sd.transpose(-1, -2).reshape(bb, G, _BINS * R)
    pos = sp.clamp_min(0).transpose(-1, -2).reshape(bb, G, _BINS * R)
    if R == 1:
        by_pos = torch.argsort(pos, dim=-1)
        sd, pos = sd.gather(-1, by_pos), pos.gather(-1, by_pos)
    order = torch.sort(sd, dim=-1, stable=True).indices[..., :k]
    d_k = sd.gather(-1, order)
    p_k = pos.gather(-1, order)
    i_k = ids.to(torch.int32).gather(-1, p_k.reshape(bb, G * k)).reshape(
        bb, G, k)
    return d_k, torch.where(torch.isinf(d_k), -1, i_k)


def fold_topk(dist: torch.Tensor, ids: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold arm over min-space distances [bb, G, cap] (cap a multiple
    of 128; +inf where masked) with the lists' ids [bb, cap]: binned_deep's
    cascade (``fused_topk.fold_lane_stacks``) at depth R = ``fold_depth(k)``,
    every slot returned, level r of bin b at column ``r 128 + b``:
    (distances [bb, G, 128 R], ids, -1 where +inf)."""
    bb, G, cap = dist.shape
    ids = ids.to(torch.int32)[:, None, :].expand(bb, G, cap)
    sd, si = fold_lane_stacks(dist, ids, fold_depth(k))
    sd, si = sd.flatten(-2), si.flatten(-2)
    return sd, torch.where(torch.isinf(sd), -1, si)
