"""Interop suite of the port: the native library's bindings, zero-copy
bridges between runtimes, and in-place proofs on the card."""
