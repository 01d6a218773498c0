"""Carries ``raft_tpu`` index state across to the port.

The reference package's indexes are handed over as numpy arrays (from
``np.asarray`` on its fields, or from its index files) so that both
packages can be searched over one shared index: builds cannot match bit
for bit, because ``jax.random`` and ``torch.Generator`` draw different
numbers.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import as_tensor, resolve_device
from raft_tpu_torch.distance.types import resolve_metric
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, nn_descent


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
