"""NumPy-format index files — the same container ``raft_tpu`` writes.

A copy of ``raft_tpu/core/serialize.py``'s ``write_index_file`` /
``read_index_file`` (the port imports nothing of the JAX package): the
``RAFT_TPU`` magic, a length-prefixed JSON header, then one ``.npy`` block
per named array. Files written by either package load in the other.
"""

from __future__ import annotations

import json
import struct
from typing import Any

import numpy as np

MAGIC = b"RAFT_TPU"


def write_index_file(path: str, kind: str, version: int,
                     meta: dict[str, Any], arrays: dict[str, Any]) -> None:
    """Versioned index container: header + json meta + named .npy blocks."""
    with open(path, "wb") as fp:
        fp.write(MAGIC)
        meta_blob = json.dumps(
            {"kind": kind, "version": version, "meta": meta,
             "arrays": list(arrays)}
        ).encode()
        fp.write(struct.pack("<q", len(meta_blob)))
        fp.write(meta_blob)
        for arr in arrays.values():
            np.save(fp, np.asarray(arr), allow_pickle=False)


def read_index_file(path: str, kind: str, min_version: int = 0):
    """Returns (version, meta, arrays-dict of numpy arrays)."""
    with open(path, "rb") as fp:
        magic = fp.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a raft_tpu index file")
        (n,) = struct.unpack("<q", fp.read(8))
        header = json.loads(fp.read(n).decode())
        if header["kind"] != kind:
            raise ValueError(
                f"{path}: expected index kind {kind!r}, found "
                f"{header['kind']!r}")
        if header["version"] < min_version:
            raise ValueError(
                f"{path}: version {header['version']} < required "
                f"{min_version}")
        arrays = {name: np.load(fp, allow_pickle=False)
                  for name in header["arrays"]}
        return header["version"], header["meta"], arrays
