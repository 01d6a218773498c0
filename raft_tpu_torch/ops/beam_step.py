"""One CAGRA beam-search step: the CUDA kernel and its plain version.

Replaces ``raft_tpu/ops/beam_step.py:_beam_step_kernel`` (``pallas_call``
at :443, entry ``beam_merge_step`` :319), and with it the interpret-only
oracle of its packed scoring, ``raft_tpu/analysis/contract_drivers.py:375
_packed_score_xla``, whose counterpart is :func:`packed_score_plain`.

One step per query: score the candidates (pre-scored, for seeding; or
decoded from the packed inline rows of the query's ``width`` parents),
merge them into the sorted itopk buffer with the bitonic network, blank
windowed duplicates (the kept copy inherits the explored flag), and pick
the first ``width`` unexplored entries as the next parents.

Layout differs from the reference in two ways, both natural for CUDA:
per-query state is row-major ``[m, L]`` (the reference keeps it transposed,
``[L, m]``, for the TPU's sublanes), and the packed arm takes the whole
table ``nbr_pack`` [n, W] with ``parents`` [m, width] and the scaled
query ``qs`` [m, d] bf16 — the kernel reads the parents' rows itself,
where the reference is handed them pre-gathered with a query tiled to
[m, 4, deg * d/4].

Packed scoring rounds as the reference's does: each byte's product is
``bf16(int8 * qs)``, the four bytes of a code word are added in f32 in the
order j = 0..3 from 0, and a neighbour's d/4 word sums (zero-padded to a
power of two) are added by a fixed tree of adjacent pairs — where the
reference's one-hot matmul leaves the order open. Kernel and plain version
share that tree, so they agree bit for bit.

On a CUDA tensor :func:`beam_merge_step` launches
``csrc/cagra_beam_step.cu`` or raises; on a CPU tensor it runs
:func:`beam_merge_step_plain`; nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from raft_tpu_torch.matrix.bitonic import sort_by_key
from raft_tpu_torch.ops import _build

_INVALID = -1
LL_MAX = 2048           # the kernel's largest next_pow2(L + C)
WIDTH_MAX = 64
D_MAX = 2048


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def _a128(v: int) -> int:
    return -(-int(v) // 128) * 128


def packed_row_layout(deg: int, d: int, ip: bool = False):
    """The packed inline row layout: ``(dw, o_norm, o_id, W)`` — code-word
    count, norm-region offset, id-region offset and row width in int32
    words, every region padded to a multiple of 128 words; inner-product
    rows carry no norm region. The same layout as the reference
    (``raft_tpu/ops/beam_step.py:81``), so packed tables agree word for
    word."""
    dw = deg * (d // 4)
    o_norm = _a128(dw)
    o_id = o_norm + (0 if ip else _a128(deg))
    return dw, o_norm, o_id, o_id + _a128(deg)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def packed_score_plain(qs: torch.Tensor, nbr_pack: torch.Tensor,
                       parents: torch.Tensor, deg: int, d: int,
                       ip: bool = False):
    """Scores of the parents' packed neighbours: (cand_d [m, C] f32,
    cand_i [m, C] int32), C = width * deg, in parent-major order. L2
    scores are ``norm - dots`` (||q||^2 dropped), inner product ``-dots``;
    an id < 0 or a parent < 0 scores +inf, and a parent < 0 gives ids
    -1."""
    m, width = parents.shape
    dw, o_norm, o_id, _ = packed_row_layout(deg, d, ip)
    dq = d // 4
    rows = nbr_pack[parents.clamp_min(0).long()]          # [m, width, W]
    words = rows[..., :dw].reshape(m, width, deg, dq)
    q = qs.float().reshape(m, 1, 1, dq, 4)     # q[.., t, j] = qs[4t + j]
    acc = torch.zeros(words.shape, dtype=torch.float32, device=qs.device)
    for j in range(4):
        b = (words >> (8 * j)) & 0xFF
        b = b - ((b & 0x80) << 1)              # sign-extend the byte
        acc = acc + (b.float() * q[..., j]).to(torch.bfloat16).float()
    P = _next_pow2(dq)
    if P > dq:
        acc = torch.nn.functional.pad(acc, (0, P - dq))
    while acc.shape[-1] > 1:                              # adjacent pairs
        acc = acc[..., 0::2] + acc[..., 1::2]
    dots = acc[..., 0]                                    # [m, width, deg]
    ids = rows[..., o_id:o_id + deg]
    if ip:
        cd = -dots
    else:
        cd = rows[..., o_norm:o_norm + deg].contiguous().view(
            torch.float32) - dots
    pok = (parents >= 0)[:, :, None]
    cd = torch.where((ids < 0) | ~pok, torch.inf, cd)
    ids = torch.where(pok, ids, _INVALID)
    return (cd.reshape(m, width * deg),
            ids.reshape(m, width * deg).to(torch.int32))


def _sort_rows(kd: torch.Tensor, kie: torch.Tensor):
    """The bitonic network over each row, ``kie`` riding as payload."""
    kd, (kie,) = sort_by_key(kd, kie)
    return kd, kie


def _dedup_rows(kd: torch.Tensor, kie: torch.Tensor, window: int):
    """Windowed dup collapse on sorted rows: a copy within ``window``
    slots after an earlier copy of its id is blanked to (+inf, -1) and
    its explored flag is inherited by the earlier copy, one window step
    after the other. ``kie`` packs ``(id << 1) | explored``."""
    ids = kie >> 1
    dup = torch.zeros(kie.shape, dtype=torch.bool, device=kie.device)
    for s in range(1, window + 1):
        eq = (ids[:, s:] == ids[:, :-s]) & (ids[:, s:] >= 0)
        dup[:, s:] |= eq
        inherit = eq.to(kie.dtype) * (kie[:, s:] & 1)
        kie = kie | torch.nn.functional.pad(inherit, (0, s))
    kd = torch.where(dup, torch.inf, kd)
    kie = torch.where(dup, _INVALID, kie)
    return kd, kie


def _pick_rows(kd: torch.Tensor, kie: torch.Tensor, width: int):
    """The first ``width`` unexplored live entries of each row become
    parents [m, width] (-1 where none is left) and are marked explored."""
    ids = kie >> 1
    une = ((kie & 1) == 0) & (ids >= 0) & (kd < torch.inf)
    rank = torch.cumsum(une.to(torch.int32), 1) - 1
    sel = une & (rank < width)
    parents = torch.stack(
        [torch.where(sel & (rank == j), ids, _INVALID).amax(1)
         for j in range(width)], 1)
    return parents.to(torch.int32), kie | sel.to(kie.dtype)


def beam_merge_step_plain(buf_d, buf_i, buf_e, qs=None, nbr_pack=None,
                          parents=None, cand_d=None, cand_i=None, *,
                          deg: int = 0, d: int = 0, width: int,
                          window: int = 2, ip: bool = False,
                          emit_cands: bool = False):
    """The kernel's function in plain PyTorch (arguments and results as
    :func:`beam_merge_step`)."""
    scored = cand_d is not None
    if scored:
        ci = cand_i.to(torch.int32)
        cd = torch.where(ci < 0, torch.inf, cand_d.float())
    else:
        cd, ci = packed_score_plain(qs, nbr_pack, parents, deg, d, ip)
    m, L = buf_d.shape
    C = ci.shape[1]
    pad = _next_pow2(L + C) - L - C
    dev = buf_d.device
    kd = torch.cat([buf_d.float(), cd,
                    torch.full((m, pad), torch.inf, device=dev)], 1)
    kie = torch.cat([buf_i.to(torch.int32) * 2 | (buf_e.to(torch.int32) & 1),
                     ci * 2,
                     torch.full((m, pad), _INVALID, dtype=torch.int32,
                                device=dev)], 1)
    kd, kie = _sort_rows(kd, kie)
    kd, kie = _dedup_rows(kd, kie, window)
    kd, kie = kd[:, :L], kie[:, :L]
    par, kie = _pick_rows(kd, kie, width)
    out = (kd.contiguous(), (kie >> 1).contiguous(), (kie & 1).contiguous(),
           par)
    if emit_cands and not scored:
        out += (cd, ci)
    return out


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def _check(buf_d, buf_i, buf_e, qs, nbr_pack, parents, cand_d, cand_i, deg,
           d, width, window, ip):
    m, L = buf_d.shape
    if tuple(buf_i.shape) != (m, L) or tuple(buf_e.shape) != (m, L):
        raise ValueError("buf_d, buf_i and buf_e must share one [m, L] shape")
    if width < 1 or window < 0:
        raise ValueError(f"width must be >= 1 and window >= 0, got "
                         f"{width}, {window}")
    if cand_d is not None:
        if cand_i is None or cand_d.shape != cand_i.shape or \
                cand_d.shape[0] != m:
            raise ValueError("cand_d and cand_i must share one [m, C] shape")
        return
    if qs is None or nbr_pack is None or parents is None:
        raise ValueError("pass cand_d + cand_i, or qs + nbr_pack + parents")
    if d % 4 or d < 4:
        raise ValueError(f"packed scoring needs d % 4 == 0, got {d}")
    if tuple(qs.shape) != (m, d) or tuple(parents.shape) != (m, width):
        raise ValueError(f"qs must be [m, d] = {(m, d)} and parents "
                         f"[m, width] = {(m, width)}")
    if nbr_pack.shape[1] != packed_row_layout(deg, d, ip)[3]:
        raise ValueError(f"nbr_pack rows are {nbr_pack.shape[1]} words, the "
                         f"layout of deg={deg}, d={d} has "
                         f"{packed_row_layout(deg, d, ip)[3]}")


def beam_merge_step(buf_d: torch.Tensor, buf_i: torch.Tensor,
                    buf_e: torch.Tensor, qs: Optional[torch.Tensor] = None,
                    nbr_pack: Optional[torch.Tensor] = None,
                    parents: Optional[torch.Tensor] = None,
                    cand_d: Optional[torch.Tensor] = None,
                    cand_i: Optional[torch.Tensor] = None, *,
                    deg: int = 0, d: int = 0, width: int, window: int = 2,
                    ip: bool = False, emit_cands: bool = False):
    """One beam step over the sorted buffer ``buf_d`` / ``buf_i`` /
    ``buf_e`` [m, L] (f32 distances, int32 ids, int32 explored flags).

    Pass ``cand_d`` + ``cand_i`` [m, C] (pre-scored candidates, used for
    seeding), or ``qs`` [m, d] bf16 (the query times 2 * code_scale for
    L2, code_scale for IP) + ``nbr_pack`` [n, W] + ``parents`` [m, width]
    (the parents the packed rows are read for; < 0 masks the parent's
    block). Returns (buf_d, buf_i, buf_e, parents [m, width]): the buffer
    distance-sorted, deduplicated and cut to L, with the picked parents
    marked explored. ``emit_cands`` (packed arm) also returns the step's
    scored candidates (cand_d [m, C] f32, cand_i [m, C] int32)."""
    _check(buf_d, buf_i, buf_e, qs, nbr_pack, parents, cand_d, cand_i, deg,
           d, width, window, ip)
    kw = dict(deg=deg, d=d, width=width, window=window, ip=ip,
              emit_cands=emit_cands)
    if buf_d.device.type == "cpu":
        return beam_merge_step_plain(buf_d, buf_i, buf_e, qs, nbr_pack,
                                     parents, cand_d, cand_i, **kw)
    if not buf_d.is_cuda:
        raise ValueError(f"beam_merge_step takes CPU or CUDA tensors, got "
                         f"{buf_d.device}")
    return _launch(buf_d, buf_i, buf_e, qs, nbr_pack, parents, cand_d,
                   cand_i, **kw)


beam_merge_step.launches = 0


def _launch(buf_d, buf_i, buf_e, qs, nbr_pack, parents, cand_d, cand_i, *,
            deg, d, width, window, ip, emit_cands):
    dev = buf_d.device
    ins = (buf_i, buf_e, qs, nbr_pack, parents, cand_d, cand_i)
    if any(t is not None and t.device != dev for t in ins):
        raise ValueError("every input must be on the buffer's device")
    m, L = buf_d.shape
    scored = cand_d is not None
    C = cand_d.shape[1] if scored else width * deg
    if _next_pow2(L + C) > LL_MAX or width > WIDTH_MAX or d > D_MAX:
        raise ValueError(
            f"beam_merge_step kernel limits: next_pow2(L + C) <= {LL_MAX} "
            f"(L={L}, C={C}), width <= {WIDTH_MAX}, d <= {D_MAX}")
    i32 = torch.int32
    bd = buf_d.float().contiguous()
    bi = buf_i.to(i32).contiguous()
    be = buf_e.to(i32).contiguous()
    out_bd = torch.empty((m, L), dtype=torch.float32, device=dev)
    out_bi = torch.empty((m, L), dtype=i32, device=dev)
    out_be = torch.empty((m, L), dtype=i32, device=dev)
    out_par = torch.empty((m, width), dtype=i32, device=dev)
    out_cd = out_ci = None
    cd = ci = q = pack = par = None
    W = o_norm = o_id = 0
    if scored:
        cd = cand_d.float().contiguous()
        ci = cand_i.to(i32).contiguous()
    else:
        q = qs.to(torch.bfloat16).contiguous()
        pack = nbr_pack.to(i32).contiguous()
        if pack.data_ptr() % 16:            # the kernel reads 16-byte words
            pack = pack.clone()
        par = parents.to(i32).contiguous()
        _, o_norm, o_id, W = packed_row_layout(deg, d, ip)
        if emit_cands:
            out_cd = torch.empty((m, C), dtype=torch.float32, device=dev)
            out_ci = torch.empty((m, C), dtype=i32, device=dev)
    out = (out_bd, out_bi, out_be, out_par)
    if out_cd is not None:
        out += (out_cd, out_ci)
    if m == 0:
        return out

    lib = _build.load("cagra_beam_step")
    fn = lib.cagra_beam_step
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    ptr = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(bd), ptr(bi), ptr(be), ptr(cd), ptr(ci), ptr(q),
                ptr(pack), ptr(par), m, L, C, deg, d, W, o_norm, o_id, width,
                window, int(ip), ptr(out_bd), ptr(out_bi), ptr(out_be),
                ptr(out_par), ptr(out_cd), ptr(out_ci), stream)
    _build.check(lib, "cagra_beam_step", rc)
    beam_merge_step.launches += 1
    return out
