"""Parallelism layer of the port (only ``full_attention`` so far)."""
