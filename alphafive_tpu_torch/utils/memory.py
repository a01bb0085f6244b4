"""Order-of-magnitude device-memory estimate for a RunConfig, and the
guard the CLI runs before ``train`` and ``bench`` (port of
``alphafive_tpu/utils/memory.py``).

The estimate sums the dominant allocations of the self-play and training
program on one device, term by term as the JAX package does, with the
JAX terms' formulas where the two layouts agree (the replay ring, the
per-row recordings, the per-node tree fields, the flat parameter term)
and the port's own widths and copies where they differ:

* the tree's slot arrays: the port keeps int32 visit counts, value sums,
  child pointers and (on the capped tree only) candidate actions where
  the JAX package packs u16/i16 (``mcts/search_capped.py``);
* the leaf forward: the JAX term's four live activations, each f32 (the
  port's stem conv and batch norm run in f32 whatever the compute dtype),
  over ``E · lanes`` positions, where a Gumbel root's lanes are
  ``gumbel_m`` (the JAX term counts ``leaf_batch`` alone, which is 1 on
  the Gumbel presets and undercounts their 16-lane passes);
* the recordings: the staged chunk, the new chunk's per-ply tensors and
  their stack (three chunks where the JAX term counts two);
* the learner's training forward at ``replay.batch_size``, whose
  activations autograd keeps for the backward (no JAX term).

It is a guard, not an allocator: the CLI refuses a run whose estimate
exceeds ``BUDGET_FRACTION`` of the card's memory unless
``--allow-oversubscribe`` is given. On the CPU (host memory) there is no
guard.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from alphafive_tpu_torch.config import RunConfig

# of torch.cuda.get_device_properties(dev).total_memory: headroom for the
# caching allocator's fragmentation and library workspaces
BUDGET_FRACTION = 0.85
PARAMS_BYTES = 64_000_000


def _dtype_bytes(name: str) -> int:
    """Bytes of a dtype named as in the config; unknown names fall back
    to torch's itemsize for that name (a guard must not crash on a dtype
    it was not written for)."""
    known = {"float32": 4, "bfloat16": 2, "int16": 2}
    if name in known:
        return known[name]
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt.itemsize


def estimate_terms(cfg: RunConfig, n_devices: int = 1) -> Dict[str, int]:
    """The estimate's terms in bytes per device (see the module
    docstring); ``estimate_device_bytes`` is their sum."""
    n = max(n_devices, 1)
    e = -(-cfg.train.num_envs // n)          # envs per device
    a = cfg.env.num_actions
    nn = cfg.mcts.num_simulations + 1        # node pool
    c = cfg.mcts.branch_cap or a
    capped = cfg.mcts.branch_cap is not None

    # slot arrays [E, NN, C]: n, w (int32 or f32), p, child, and on the
    # capped tree cand_act; per node done/winner/last/count (JAX's term)
    # and the board. Select/backup temporaries double-buffer the big
    # arrays.
    slot = 4 + 4 + _dtype_bytes(cfg.mcts.prior_dtype) + 4 + (4 if capped
                                                             else 0)
    per_env_tree = nn * c * slot + nn * (1 + 1 + 4 + 4) + nn * a
    tree = int(e * per_env_tree * 1.5)

    lanes = (cfg.mcts.gumbel_m if cfg.mcts.root_selection == "gumbel"
             else cfg.mcts.leaf_batch)
    act = e * lanes * a * cfg.net.channels * 4 * 4

    # ring: board int8 + pi bf16 + tags (JAX's term)
    replay = (cfg.replay.capacity // n) * (3 * a + 3)

    # recordings: board int8 + pi f32 + tags (JAX's row), three chunks
    pending = 3 * cfg.train.selfplay_plies_per_iter * e * (5 * a + 3)

    # f32 batch-norm input and output of every conv layer, kept for the
    # backward
    layers = 2 * cfg.net.blocks + 3
    learner = (cfg.replay.batch_size // n) * a * cfg.net.channels * 4 \
        * 2 * layers

    return {"tree": tree, "act": act, "replay": replay, "pending": pending,
            "learner": learner, "params": PARAMS_BYTES}


def estimate_device_bytes(cfg: RunConfig, n_devices: int = 1) -> int:
    """Dominant per-device allocations of the train/bench program."""
    return sum(estimate_terms(cfg, n_devices).values())


def device_budget(device) -> int:
    """``BUDGET_FRACTION`` of the card's memory."""
    total = torch.cuda.get_device_properties(torch.device(device)).total_memory
    return int(BUDGET_FRACTION * total)


def budget_error(cfg: RunConfig, n_devices: int = 1,
                 budget: Optional[int] = None, device="cuda"):
    """Refusal message if the estimate busts the budget (by default
    ``device_budget(device)``), else None."""
    budget = device_budget(device) if budget is None else budget
    est = estimate_device_bytes(cfg, n_devices)
    if est <= budget:
        return None
    return (
        f"refusing to run: estimated per-device footprint {est / 1e9:.1f} "
        f"GB over {n_devices} device(s) exceeds the {budget / 1e9:.1f} GB "
        f"budget ({BUDGET_FRACTION:.0%} of the card; preset {cfg.name!r}). "
        f"Shrink train.num_envs / replay.capacity, or pass "
        f"--allow-oversubscribe to override (utils/memory.py).")
