"""Training: AdamW, the microbatched step, checkpoints and the
fault-tolerant runner (the counterpart of ``repro.train``)."""
