"""A run of the simulator's fast-path events (fast WRITEs and TRIMs) in one
launch."""
