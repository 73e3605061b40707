"""Harness pieces of the port (the verdict rule so far)."""
