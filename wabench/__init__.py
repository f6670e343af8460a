"""The benchmark of the PyTorch and CUDA port (``repro_torch``): fleets of
the paper's Table-2 drives under the Wolf manager, one cell a run
(``python3 -m wabench.run --workload <name> ...``)."""
