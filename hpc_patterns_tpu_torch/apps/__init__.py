"""Command-line apps of the port."""
