"""Utilities: alignment math and the distance-matmul precision policy."""
