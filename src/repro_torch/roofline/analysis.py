"""Three-term roofline of a step on one NVIDIA H100 (DESIGN §8).

  compute   = flops_per_chip / PEAK_FLOPS
  memory    = hbm_bytes_per_chip / HBM_BW
  collective= collective_bytes_per_chip / LINK_BW

The counts are a chip's own (``hlo_cost`` counts each rank's local ops),
so the "global / chips" formulation is the same thing.

The rates are one H100 SXM's, from NVIDIA's data sheets, and assume the
card's full 700 W limit (the chip machine reads ``NVIDIA H100 80GB HBM3,
700.00 W``): a card set lower runs slower, so a share against these rates
is stated beside the card's power limit.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 data sheet, dense (no sparsity); NVIDIA H100 80GB HBM3,
# 700.00 W
PEAK_FLOPS = 989e12        # bf16 / fp16 tensor cores, FLOP/s
HBM_BW = 3.35e12           # HBM3, bytes/s
# The collective term assumes the network between nodes: a production mesh
# (16 × 16, or 2 × 16 × 16) puts 16 GPUs on its `model` axis, which spans
# two 8-GPU NVLink nodes, so a ring over it runs at the rate of a GPU's own
# network link, one 400 Gb/s NDR InfiniBand port (ConnectX-7) per GPU as in
# a DGX H100: 50 GB/s a direction.  Within one node NVLink 4 gives a GPU
# 450 GB/s a direction (900 GB/s both ways).
LINK_BW = 50e9             # bytes/s a GPU, inter-node network


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float            # 6·N·D (or 6·N_active·D)
    useful_flops_ratio: float     # model_flops/chips / counted flops_per_chip

    @staticmethod
    def build(flops_per_chip: float, hbm_bytes_per_chip: float,
              coll: dict, model_flops: float, chips: int):
        cb = float(sum(coll.values()))
        c = flops_per_chip / PEAK_FLOPS
        m = hbm_bytes_per_chip / HBM_BW
        k = cb / LINK_BW
        terms = {"compute": c, "memory": m, "collective": k}
        bn = max(terms, key=terms.get)
        ratio = ((model_flops / chips) / flops_per_chip if flops_per_chip
                 else 0.0)
        return Roofline(flops_per_chip, hbm_bytes_per_chip, cb, coll,
                        c, m, k, bn, model_flops, ratio)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops_train(cfg, tokens: int) -> float:
    """6·N_active·D for one optimizer step over ``tokens`` tokens."""
    n = cfg.active_param_count_estimate()
    return 6.0 * n * tokens


def model_flops_decode(cfg, batch: int) -> float:
    """2·N_active per generated token (forward only)."""
    n = cfg.active_param_count_estimate()
    return 2.0 * n * batch


def model_flops_prefill(cfg, tokens: int) -> float:
    return 2.0 * cfg.active_param_count_estimate() * tokens
