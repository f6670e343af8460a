"""Model families (dense decoder so far), mirrored from ``repro.models``."""
