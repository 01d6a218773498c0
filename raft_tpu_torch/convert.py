"""Carries ``raft_tpu`` index state across to the port.

The reference package's indexes are handed over as numpy arrays (from
``np.asarray`` on its fields, or from its index files) so that both
packages can be searched over one shared index: builds cannot match bit
for bit, because ``jax.random`` and ``torch.Generator`` draw different
numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import as_tensor, resolve_device
from raft_tpu_torch.distance.types import resolve_metric
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq, \
    nn_descent


def ivf_flat_index_from_numpy(arrays: Mapping[str, np.ndarray], metric,
                              device=None,
                              storage_dtype: Optional[str] = None,
                              ) -> ivf_flat.Index:
    """An IVF-Flat index from the reference's arrays: ``centers``,
    ``storage``, ``indices``, ``list_sizes`` and, for the L2 and cosine
    metrics, ``data_norms``. ``storage_dtype="bf16"`` narrows storage that
    was widened to f32 for the file (as ``ivf_flat.save`` writes it)."""
    dev = resolve_device(device)
    storage = as_tensor(arrays["storage"], dev)
    if storage_dtype == "bf16":
        storage = storage.to(torch.bfloat16)
    norms = arrays.get("data_norms")
    return ivf_flat.Index(
        centers=as_tensor(arrays["centers"], dev, torch.float32),
        storage=storage,
        indices=as_tensor(arrays["indices"], dev, torch.int32),
        list_sizes=as_tensor(arrays["list_sizes"], dev, torch.int32),
        metric=resolve_metric(metric),
        data_norms=None if norms is None else as_tensor(norms, dev,
                                                        torch.float32),
    )


def brute_force_index_from_numpy(arrays: Mapping[str, np.ndarray], metric,
                                 device=None,
                                 metric_arg: float = 2.0
                                 ) -> brute_force.Index:
    """A brute-force index from the reference's ``dataset`` and, for the
    expanded L2 and cosine metrics, ``norms``."""
    dev = resolve_device(device)
    norms = arrays.get("norms")
    return brute_force.Index(
        dataset=as_tensor(arrays["dataset"], dev),
        metric=resolve_metric(metric),
        metric_arg=metric_arg,
        norms=None if norms is None else as_tensor(norms, dev,
                                                   torch.float32),
    )


def cagra_index_from_numpy(arrays: Mapping[str, np.ndarray], metric,
                           device=None, inline_codes: bool = True
                           ) -> cagra.Index:
    """A CAGRA index from the reference's ``dataset`` and ``graph``; the
    packed inline layout is rebuilt here, as the reference's ``load``
    rebuilds it."""
    return cagra.from_graph(arrays["dataset"], arrays["graph"], metric,
                            inline_codes=inline_codes,
                            device=resolve_device(device))


def nn_descent_index_from_numpy(arrays: Mapping[str, np.ndarray],
                                device=None) -> nn_descent.Index:
    """An nn-descent graph from the reference's ``graph`` and
    ``distances``."""
    dev = resolve_device(device)
    return nn_descent.Index(
        graph=as_tensor(arrays["graph"], dev, torch.int32),
        distances=as_tensor(arrays["distances"], dev, torch.float32))


def ivf_pq_index_from_numpy(arrays: Mapping[str, np.ndarray], metric,
                            device=None, pq_dim: Optional[int] = None,
                            pq_bits: Optional[int] = None,
                            codebook_kind: int = 0,
                            recon_scale: Optional[float] = None,
                            metric_arg: float = 2.0,
                            cache_decoded: bool = True,
                            cache_dtype: str = "auto") -> ivf_pq.Index:
    """An IVF-PQ index from the reference's arrays: ``centers``,
    ``centers_rot``, ``rotation``, ``pq_centers``, ``codes`` (uint32
    words, held here as int32 with the same bits), ``indices``,
    ``list_sizes``, ``rec_norms`` and, optionally, its cache carried
    verbatim: ``recon_cache`` (int8 rows, or uint32 packed words of the
    i4, pq4 and RaBitQ kinds) with ``recon_scale`` (an entry of
    ``arrays`` or the keyword) and whichever of ``cache_scales``,
    ``cache_qnorms`` and ``cache_fac`` the cache has. Without a cache one
    is built from the codes when ``cache_decoded`` and ``cache_dtype``
    ask for it. ``pq_dim`` and ``pq_bits`` default to what the codebooks'
    shape says."""
    dev = resolve_device(device)
    pq_centers = np.asarray(arrays["pq_centers"], np.float32)
    rot_dim = np.asarray(arrays["rotation"]).shape[0]
    if pq_dim is None:
        pq_dim = rot_dim // pq_centers.shape[2]
    if pq_bits is None:
        pq_bits = int(pq_centers.shape[1]).bit_length() - 1

    def words(a):
        a = np.ascontiguousarray(np.asarray(a))
        return as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a,
                         dev, torch.int32)

    def f32(name):
        a = arrays.get(name)
        return None if a is None else as_tensor(a, dev, torch.float32)

    index = ivf_pq.Index(
        centers=f32("centers"), centers_rot=f32("centers_rot"),
        rotation=f32("rotation"), pq_centers=as_tensor(pq_centers, dev),
        codes=words(arrays["codes"]),
        indices=as_tensor(arrays["indices"], dev, torch.int32),
        list_sizes=as_tensor(arrays["list_sizes"], dev, torch.int32),
        rec_norms=f32("rec_norms"),
        metric=resolve_metric(metric), pq_dim_=int(pq_dim),
        metric_arg=float(metric_arg), codebook_kind=int(codebook_kind),
        pq_bits=int(pq_bits), cache_decoded=bool(cache_decoded),
        cache_dtype=str(cache_dtype))
    cache = arrays.get("recon_cache")
    if cache is None:
        return ivf_pq._attach_cache(index)
    cache = np.asarray(cache)
    if cache.dtype not in (np.int8, np.uint32, np.int32):
        raise ValueError(f"recon_cache must be int8 rows or uint32 words, "
                         f"got {cache.dtype}")
    if recon_scale is None:
        recon_scale = (float(np.asarray(arrays["recon_scale"]))
                       if "recon_scale" in arrays else 1.0)
    return dataclasses.replace(
        index,
        recon_cache=(as_tensor(cache, dev, torch.int8)
                     if cache.dtype == np.int8 else words(cache)),
        recon_scale=float(np.float32(recon_scale)),
        cache_scales=f32("cache_scales"), cache_qnorms=f32("cache_qnorms"),
        cache_fac=f32("cache_fac"))
