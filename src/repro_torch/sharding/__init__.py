"""Sharding: the logical-axis rules, the automatic placement and the
gradient codec (the counterpart of ``repro.sharding``). Placement is a
description for the production meshes (``launch/mesh.py``): one process
here holds one card."""
