"""Batched decode of coded grid tiles (parallel/coded_grid)."""
