"""Examples over the port's entry points, each the counterpart of the file
of the same name in the repository's ``examples/``; run one with
``python -m repro_torch.examples.<name>``."""
