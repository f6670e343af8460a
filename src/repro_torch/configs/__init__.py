"""Model configurations (data only), mirrored from ``repro.configs``."""
