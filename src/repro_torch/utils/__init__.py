"""Cost tooling: the H100 roofline, the op count and the dry-run report
(the counterpart of ``repro.utils``)."""
