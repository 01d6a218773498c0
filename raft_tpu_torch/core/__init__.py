"""Core layer: device resolution, bitset, index-file serialization."""
