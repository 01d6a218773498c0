"""Cluster layer: the kmeans helpers balanced kmeans needs, kmeans_balanced."""
