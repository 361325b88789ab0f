"""Beyond-paper application: MoE dispatch capacity from sampled CR (DESIGN §4).

Block-sparse MoE kernels (grouped/megablocks-style) materialize the dispatch
as a block-sparse structure over (token-group × expert): a block is nonzero
iff any token in the group routes to that expert.  Sizing the grouped-GEMM
buffers needs the number of nonzero blocks — exactly the paper's
"output structure" question, with

    FLOP  := token-level assignments   (exact & cheap: k per token)
    NNZ   := distinct (group, expert) blocks (needs the dedup pass)
    CR    := assignments per block  (the batching density)

The paper's estimator transfers verbatim: sample groups, compute the exact
sampled block count z* and sampled assignments f*, predict CR* = f*/z* and
   blocks* = total_assignments / CR*.

Host (numpy) for planning, copied from the JAX package, and a torch twin
that runs on the tensor's device (the card, or the host in tests).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MoECapacityPlan:
    predicted_blocks: float       # predicted nonzero (group, expert) blocks
    exact_sample_blocks: int      # z*
    sampled_assignments: int      # f*
    total_assignments: int        # F (exact)
    compression_ratio: float      # CR* = f*/z*
    per_expert_capacity: np.ndarray  # predicted token slots per expert

    def block_buffer_size(self, safety: float = 1.15) -> int:
        return int(np.ceil(self.predicted_blocks * safety))


def dispatch_sample_groups(tokens: int, group_size: int, seed: int = 0,
                           sample_fraction: float = 0.003,
                           sample_cap: int = 300) -> np.ndarray:
    """The group ids ``predict_dispatch_capacity`` samples (with
    replacement, paper Algorithm 2 style), for a twin to reuse."""
    num_groups = max(1, tokens // group_size)
    sample_num = max(1, min(int(sample_fraction * num_groups), sample_cap))
    rng = np.random.default_rng(seed)
    return (num_groups * rng.random(sample_num)).astype(np.int64).clip(
        0, num_groups - 1)


def predict_dispatch_capacity(expert_ids: np.ndarray, num_experts: int,
                              group_size: int, seed: int = 0,
                              sample_fraction: float = 0.003,
                              sample_cap: int = 300) -> MoECapacityPlan:
    """``expert_ids``: (tokens, k) routed expert per token per top-k slot."""
    expert_ids = np.asarray(expert_ids)
    tokens, k = expert_ids.shape
    total_assignments = tokens * k

    # exact per-expert assignment counts (the "FLOP per output row" analogue)
    flopr_e = np.bincount(expert_ids.reshape(-1), minlength=num_experts)

    gids = dispatch_sample_groups(tokens, group_size, seed, sample_fraction,
                                  sample_cap)

    f_star = 0
    z_star = 0
    for g in gids:
        sl = expert_ids[g * group_size:(g + 1) * group_size].reshape(-1)
        f_star += sl.size
        z_star += np.unique(sl).size
    cr = f_star / max(z_star, 1)
    predicted_blocks = total_assignments / cr
    per_expert = np.ceil(flopr_e / cr)
    return MoECapacityPlan(predicted_blocks, int(z_star), int(f_star),
                           int(total_assignments), float(cr), per_expert)


def predict_group_capacity(expert_ids: np.ndarray, num_experts: int,
                           group_size: int, seed: int = 0,
                           sample_fraction: float = 0.01,
                           sample_cap: int = 300,
                           safety: float = 1.1) -> int:
    """Per-(group, expert) token-slot capacity from sampled groups.

    The companion to ``predict_dispatch_capacity``: blocks* sizes the
    block-sparse buffer TOTAL; this sizes the static per-expert slot count
    that ``models.moe.apply_moe`` needs.  Samples groups (Algorithm 2 style),
    measures the max per-(group, expert) load on the sample, and adds a
    safety factor — replacing the blind ``capacity_factor`` guess with a
    measured statistic.
    """
    expert_ids = np.asarray(expert_ids)
    tokens, k = expert_ids.shape
    num_groups = max(1, tokens // group_size)
    sample_num = max(1, min(int(max(sample_fraction, 0.003) * num_groups),
                            sample_cap))
    rng = np.random.default_rng(seed)
    gids = (num_groups * rng.random(sample_num)).astype(np.int64).clip(
        0, num_groups - 1)
    peak = 0
    for g in gids:
        sl = expert_ids[g * group_size:(g + 1) * group_size].reshape(-1)
        peak = max(peak, int(np.bincount(sl, minlength=num_experts).max()))
    cap = int(np.ceil(peak * safety))
    return max(4, -(-cap // 4) * 4)


def exact_dispatch_blocks(expert_ids: np.ndarray, group_size: int) -> int:
    """Ground truth — the precise method (symbolic pass over all groups)."""
    expert_ids = np.asarray(expert_ids)
    tokens, k = expert_ids.shape
    num_groups = max(1, tokens // group_size)
    gid = (np.arange(tokens) // group_size).clip(0, num_groups - 1)
    keys = np.repeat(gid, k) * np.int64(expert_ids.max() + 2) + expert_ids.reshape(-1)
    return int(np.unique(keys).size)


def sampled_dispatch_counts_torch(expert_ids: torch.Tensor, group_size: int,
                                  group_sample: torch.Tensor):
    """(z*, f*) of the sampled groups: z* the distinct (group, expert)
    blocks, a 0-d int64 tensor on ``expert_ids``' device (a sort along each
    group and a neighbour comparison), f* the sampled assignments (an int,
    known from the shapes)."""
    tokens = expert_ids.shape[0]
    dev = expert_ids.device
    # gather sampled groups: (S, group_size*k)
    offs = torch.arange(group_size, dtype=torch.int64, device=dev)
    tok_ix = group_sample.to(dev).long()[:, None] * group_size + offs[None, :]
    sl = expert_ids[tok_ix.clamp(0, tokens - 1)].reshape(
        group_sample.shape[0], -1)
    srt = torch.sort(sl, dim=-1).values
    distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(-1)
    return distinct.sum(), sl.numel()


def predict_dispatch_capacity_torch(expert_ids: torch.Tensor, num_experts: int,
                                    group_size: int,
                                    group_sample: torch.Tensor):
    """Torch twin of the sampled estimate on explicit sampled groups
    ``group_sample`` (a static sample count).  Returns (blocks*, CR*,
    flopr_e): blocks* and CR* float32 0-d tensors, as the JAX twin computes
    them (``CR* = f* / max(z*, 1)`` in float32), flopr_e int32 (E,).

    Everything stays on ``expert_ids``' device; nothing is read back."""
    tokens, k = expert_ids.shape
    total_assignments = tokens * k
    flat = expert_ids.reshape(-1).long()
    flopr_e = torch.zeros(num_experts, dtype=torch.int32,
                          device=expert_ids.device)
    flopr_e.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    z_star, f_star = sampled_dispatch_counts_torch(expert_ids, group_size,
                                                   group_sample)
    # ``scalar / tensor`` would multiply by a rounded reciprocal: divide
    # tensors so that each quotient is rounded once, as JAX's is
    z = torch.clamp(z_star, min=1).to(torch.float32)
    cr = z.new_full((), f_star) / z
    return cr.new_full((), total_assignments) / cr, cr, flopr_e
