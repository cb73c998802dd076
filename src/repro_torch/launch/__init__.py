"""Launch helpers of the port. Mirrors ``src/repro/launch/``."""
