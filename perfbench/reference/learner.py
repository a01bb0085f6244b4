"""The learner's loss and optimizer steps, from their equations, in f32.

Loss: policy cross-entropy ``−Σ π · log softmax(logits)`` averaged over
the rows whose π is a target (``pi_valid``), plus ``value_loss_weight`` ×
the squared value error averaged over the rows whose game ended
(``z_valid``); each average divides by max(count, 1). The forward is
the configuration's architecture's training forward (`arch`, as
``perfbench/generator.py::Arch`` binds it: its ``forward_train`` and
``features``), which normalises by the batch's statistics.

Step ``n`` (from 0): gradients clipped to global norm 1 (divided by the
norm when it is 1 or more), Adam (0.9, 0.999, eps 1e-8, bias corrections
in f32), plus ``l2_coef`` × the weight on conv and dense kernels, times
``−lr_n`` with ``lr_n = learning_rate · min(n, warmup) / warmup``, times
the lr multiplier.

A batch is built from ring rows (board, player to move, last move, π,
z and its two masks) and one of the square's eight symmetries a row:
symmetry k = 4 · flip + r maps cell i of the result to cell ``perm[k, i]``
of the row, where ``perm[k]`` is the cell grid, mirrored left to right
when ``flip``, turned r quarter turns counter-clockwise; π moves with the
board and the last move to the cell its stone went to.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import net as ref_net

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SYMMETRIES = 8


def dihedral(size: int):
    """(perm, inv) int64 [8, size²]: the source cell of each cell under
    symmetry k, and the cell each source cell goes to."""
    base = np.arange(size * size).reshape(size, size)
    perm = np.stack([np.rot90(np.fliplr(base) if flip else base, r).ravel()
                     for flip in (False, True) for r in range(4)])
    inv = np.empty_like(perm)
    for k in range(SYMMETRIES):
        inv[k, perm[k]] = np.arange(size * size)
    return perm, inv


def batch_from_rows(arch, size: int, sym: torch.Tensor, rows) -> List:
    """[features, π, z, z_valid, pi_valid] (f32) of ring rows under
    symmetries `sym` [B], the features `arch.features`'s."""
    board, to_play, last, pi, z, z_valid, pi_valid = rows
    dev = board.device
    perm, inv = (torch.from_numpy(t).to(dev) for t in dihedral(size))
    k = sym.long()
    board = board.gather(1, perm[k])
    pi = pi.float().gather(1, perm[k])
    last = last.long()
    last = torch.where(last < 0, last, inv[k, last.clamp(min=0)])
    feats = arch.features(size, board, to_play, last)
    return [feats, pi, z.float(), z_valid.float(), pi_valid.float()]


def leaves(tree, prefix=()) -> Dict[str, torch.Tensor]:
    """{"a/b/c": tensor} of a nested tree, in key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _rebuild(flat: Dict[str, torch.Tensor]):
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def loss(arch, params, batch, value_weight: float,
         quant: Optional[Callable] = None) -> torch.Tensor:
    feats, pi, z, z_valid, pi_valid = batch
    logits, value = arch.forward_train(params, feats, quant)
    logp = torch.log_softmax(logits, dim=-1)
    ce = (pi * logp).sum(-1)
    policy = -(ce * pi_valid).sum() / pi_valid.sum().clamp(min=1.0)
    value_loss = (((value - z) ** 2) * z_valid).sum() \
        / z_valid.sum().clamp(min=1.0)
    return policy + value_weight * value_loss


def learning_rate(lr: float, warmup: int, count: int) -> float:
    f32 = np.float32
    steps = max(warmup, 1)
    frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
    return float((f32(0.0) - f32(lr)) * frac + f32(lr))


def run_steps(arch, params_np, batches: List, train: Dict, device,
              quant: Optional[Callable] = None, lr_scale: float = 1.0):
    """Follow ``len(batches)`` steps from the flax-layout `params_np`, the
    net `arch.forward_train`'s.

    Returns {"losses": [float], "first_grad": {leaf: ‖clipped g₀‖},
    "raw_grad": {leaf: ‖g₀‖}, "change": {leaf: ‖p_K − p_0‖}} with leaves
    named "layer/param"."""
    p0 = leaves(ref_net.tree_to_torch(params_np, device))
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    out = {"losses": [], "first_grad": {}, "raw_grad": {}}
    names = list(p)
    with ref_net.no_tf32():
        for n, batch in enumerate(batches):
            lval = loss(arch, _rebuild(p), [t.float() for t in batch],
                        float(train["value_loss_weight"]), quant)
            grads = torch.autograd.grad(lval, [p[k] for k in names])
            out["losses"].append(float(lval.detach()))
            with torch.no_grad():
                norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g)
                                 for g in grads]))
                div = norm if float(norm) >= 1.0 else torch.ones_like(norm)
                f32 = np.float32
                c1 = float(f32(1) - f32(ADAM_B1) ** f32(n + 1))
                c2 = float(f32(1) - f32(ADAM_B2) ** f32(n + 1))
                lr = learning_rate(float(train["learning_rate"]),
                                   int(train["lr_warmup_steps"]), n)
                for k, g in zip(names, grads):
                    g = g / div
                    if n == 0:
                        out["first_grad"][k] = float(
                            torch.linalg.vector_norm(g))
                        out["raw_grad"][k] = float(
                            torch.linalg.vector_norm(g * div))
                    mu[k] = ADAM_B1 * mu[k] + (1 - ADAM_B1) * g
                    nu[k] = ADAM_B2 * nu[k] + (1 - ADAM_B2) * g * g
                    u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
                    if k.endswith("/kernel"):
                        u = u + float(train["l2_coef"]) * p[k]
                    p[k] += -lr * lr_scale * u
    out["change"] = {k: float(torch.linalg.vector_norm(p[k].detach()
                                                       - p0[k]))
                     for k in names}
    return out
