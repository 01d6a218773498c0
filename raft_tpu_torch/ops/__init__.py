"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version in the same module:

    fused_topk.fused_knn_topk      brute-force distance + top-k
                                   (replaces raft_tpu/ops/fused_topk.py
                                   _fused_kernel, exact and fold arms)
    ivf_scan.ivf_list_scan_topk    IVF list scan + per-list top-k
                                   (replaces raft_tpu/ops/ivf_scan.py
                                   _scan_kernel: float, int8 and packed
                                   storage; exact, binned, binned_deep
                                   and fold extraction)
    graph_join.graph_local_join    nn-descent local join: score + unique
                                   top-K merge (replaces raft_tpu/ops/
                                   graph_join.py _join_kernel)
    beam_step.beam_merge_step      one CAGRA beam step: packed int8
                                   scoring, bitonic merge, windowed dedup,
                                   parent pick (replaces raft_tpu/ops/
                                   beam_step.py _beam_step_kernel)

Sources live in ``csrc/``; ``_build`` compiles each with nvcc into a shared
library with a plain C interface at first use and loads it with ctypes.
Nothing is built or launched when a module is imported.
"""
