"""Flash attention forward (prefill / dense path)."""
