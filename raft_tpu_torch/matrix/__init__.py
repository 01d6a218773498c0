"""Matrix layer: the select_k top-k engine."""
