"""Distance layer: metric types, pairwise distances, fused L2 1-NN."""
