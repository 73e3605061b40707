"""Model stack of the port: transformer, paged decode, serving engine."""
