"""raft_tpu_torch — the PyTorch/CUDA port of ``raft_tpu`` for NVIDIA Hopper.

The JAX package ``raft_tpu`` stays the reference; this package computes the
same functions with plain PyTorch around hand-written CUDA kernels, keeps
the same on-disk index format, and mirrors the reference's layout so
``raft_tpu_torch/neighbors/ivf_flat.py`` is the counterpart of
``raft_tpu/neighbors/ivf_flat.py``. It never imports ``jax`` or
``raft_tpu``.

Layer map (the ported slice; see ROADMAP.md for what is still to come):

    core       device resolution, bitset, index-file serialization
    utils      alignment math, the f32 distance-matmul policy
    matrix     select_k (stable top-k with the reference's NaN/integer rules)
    distance   metric types, pairwise distances, fused L2 1-NN
    cluster    the kmeans pieces balanced kmeans needs, kmeans_balanced
    neighbors  common (filters, merge_topk), brute_force, ivf_flat
    ops        the hand-written CUDA kernels (fused_topk, ivf_scan), each
               beside its plain PyTorch version, and their nvcc builder
    convert    carries raft_tpu index state (numpy arrays) into the port

Device rule: public entry points that take data (``build``, ``load``,
``knn``, ``fit``, ``pairwise_distance``, the ``convert`` helpers, ...) run
on ``cuda`` unless the caller passes ``device="cpu"``, and raise when no
card is present and no device was given. Entry points that take an index
run on the device the index lives on. A kernel wrapper runs its kernel on
CUDA tensors and its plain version on CPU tensors, and nothing else.
"""

__version__ = "0.1.0"
