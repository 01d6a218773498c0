"""Neighbors layer: common filters and merges, brute_force, ivf_flat."""
