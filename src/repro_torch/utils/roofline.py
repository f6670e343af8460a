"""Roofline terms for one NVIDIA H100 (the counterpart of
``repro.utils.roofline``, whose constants are a TPU's; none of them
carries over).

Hardware constants, from NVIDIA's H100 SXM data sheet (dense rates, no
sparsity, at the full 700 W power limit; a card set below it runs slower):
    989 TFLOP/s bf16 and 67 TFLOP/s fp32 (outside the tensor cores),
    3.35 TB/s HBM3, NVLink 4 at 450 GB/s a direction.

All three terms are computed PER DEVICE, so
    compute    = flops_dev / peak of the step's dtype
    memory     = bytes_dev / HBM_BW
    collective = coll_bytes_dev / NVLINK_BW
which equals the global form (global = dev × chips on both numerator and
denominator).
"""

from __future__ import annotations

import dataclasses

# dense peak rates of the operations' type (H100 SXM data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12  # B/s (H100 SXM data sheet)
NVLINK_BW = 450e9  # B/s a direction (NVLink 4, H100 SXM data sheet)


@dataclasses.dataclass
class Roofline:
    flops_dev: float
    hbm_bytes_dev: float
    coll_bytes_dev: float
    n_chips: int
    model_flops_global: float = 0.0  # 6·N·D (train) or 2·N·D (inference)
    dtype: str = "bfloat16"  # the products' type: which peak bounds them

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.dtype]

    @property
    def compute_s(self) -> float:
        return self.flops_dev / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_dev / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted flops: how much of the work is 'useful'."""
        total = self.flops_dev * self.n_chips
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU upper bound: useful flops / (time at the dominant
        term × peak)."""
        t = self.bound_s
        if t <= 0:
            return 0.0
        return (self.model_flops_global / self.n_chips) / (
            t * self.peak_flops)

    def to_dict(self) -> dict:
        return {
            "flops_dev": self.flops_dev,
            "hbm_bytes_dev": self.hbm_bytes_dev,
            "coll_bytes_dev": self.coll_bytes_dev,
            "n_chips": self.n_chips,
            "model_flops_global": self.model_flops_global,
            "dtype": self.dtype,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def memory_floor_bytes(
    kind: str,
    *,
    params_bytes_dev: float,
    cache_bytes_dev: float = 0.0,
    act_boundary_bytes_dev: float = 0.0,
) -> float:
    """Analytic lower bound on per-device HBM traffic for one step.

      decode : stream weights once + read the KV cache once
      prefill: stream weights + write cache + activation boundaries (remat)
      train  : weights bf16 r + grad f32 w + (m,v,master) f32 r/w
               (= 30 bytes/param) + 2× activation boundaries
    """
    if kind == "decode":
        return params_bytes_dev + cache_bytes_dev
    if kind == "prefill":
        return params_bytes_dev + cache_bytes_dev + act_boundary_bytes_dev
    per_param = 2 + 4 + 3 * 4 + 3 * 4  # bf16 read + f32 grad + opt r/w
    return params_bytes_dev / 2 * per_param + 2 * act_boundary_bytes_dev


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference-style passes (attention
    flops excluded by convention)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens
