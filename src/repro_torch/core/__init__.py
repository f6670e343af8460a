"""Core: SSD state, workloads, OP allocation, the simulator and the block
managers (the counterpart of ``repro.core``)."""
