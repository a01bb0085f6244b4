"""Learner: loss, optimizer, one step (port of
``alphafive_tpu/train/learner.py``).

The loss is value MSE masked by ``z_valid`` plus policy cross-entropy
against the search's π masked by ``pi_valid``, both renormalised. Kernels
(conv and dense weights) are regularised by decoupled weight decay under
Adam; only ``sgd`` puts the L2 term into the loss (the JAX module
docstring gives the measured head collapse that L2-in-the-loss caused
under Adam). ``l2_loss`` is logged either way, with KL(π ‖ p), the value
MAE and the entropy of π.

The optimizer is written out by hand, equal to the JAX package's optax
chain (`make_optimizer`; here ``init_opt_state`` and ``optimizer_update``
are its ``init`` and ``update``): clip by global norm 1 (dividing by the norm,
as optax does), then Adam (0.9, 0.999, eps 1e-8), decay ``l2_coef · p``
on kernels, and × −lr from a linear warm-up from 0 that reads the count
before incrementing it (so the first update has lr 0); ``sgd`` is optax's
momentum trace ``t = g + m · t`` in place of Adam and decay. The train
step multiplies the update by ``lr_scale``, the KL-adaptive multiplier.

The port updates the net and the optimizer state in place (JAX returns a
new state). ``step`` and the optimizer count are host integers, so the
learning rate needs no device read; ``lr_scale`` is an f32 scalar tensor
on the device, as JAX keeps it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from alphafive_tpu_torch.config import EnvConfig, NetConfig, TrainConfig
from alphafive_tpu_torch.models import nets
from alphafive_tpu_torch.models.resnet import numpy_tree
from alphafive_tpu_torch.utils import trace

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
CLIP_NORM = 1.0
AUX_KEYS = ("loss", "policy_loss", "value_loss", "l2_loss", "kl_pi_p",
            "value_mae", "entropy_pi")


@dataclasses.dataclass
class OptState:
    """Per-parameter moments in ``net.parameters()`` order. Adam: first
    and second moments; sgd: the momentum trace in ``mu`` and no ``nu``."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclasses.dataclass
class TrainState:
    net: torch.nn.Module     # params and batch-norm running statistics
    opt_state: OptState
    step: int
    lr_scale: torch.Tensor   # f32[] — KL-adaptive lr multiplier


def init_opt_state(cfg: TrainConfig, params) -> OptState:
    """Zero moments for `params` (a list of tensors)."""
    zeros = lambda: [torch.zeros_like(p) for p in params]
    return OptState(count=0, mu=zeros(),
                    nu=zeros() if cfg.optimizer != "sgd" else [])


def init_train_state(env_cfg: EnvConfig, net_cfg: NetConfig,
                     train_cfg: TrainConfig, params, batch_stats,
                     device="cuda") -> TrainState:
    """A fresh train state from flax-layout trees (a bundle's, or
    ``init_params``) on `device`."""
    net = nets.from_flax(env_cfg, net_cfg, params, batch_stats, device)
    return TrainState(net=net,
                      opt_state=init_opt_state(train_cfg,
                                               list(net.parameters())),
                      step=0, lr_scale=torch.ones((), device=device))


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """optax.linear_schedule(0 → learning_rate, lr_warmup_steps) at
    `count`, in f32 as optax computes it."""
    f32 = np.float32
    steps = max(cfg.lr_warmup_steps, 1)
    frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
    end = f32(cfg.learning_rate)
    return float((f32(0.0) - end) * frac + end)


def opt_state_to_flax(ts: TrainState) -> Dict:
    """The optimizer state as flax-layout numpy trees beside its count:
    {"count", "mu", "nu"} under Adam, {"count", "trace"} under sgd."""
    st = ts.opt_state
    tree = lambda moments: numpy_tree(ts.net.flax_tree(moments))
    if st.nu:
        return {"count": st.count, "mu": tree(st.mu), "nu": tree(st.nu)}
    return {"count": st.count, "trace": tree(st.mu)}


def _l2_of_kernels(net: torch.nn.Module) -> torch.Tensor:
    return sum(k.float().square().sum() for k in net.kernels())


def loss_fn(net: torch.nn.Module, batch, train_cfg: TrainConfig):
    """(loss, (new running statistics, aux)) with autograd on the loss.
    `batch` is (features, pi, z, z_valid[, pi_valid]) as
    ``replay.buffer.sample`` returns it."""
    feats, pi, z, z_valid, pi_valid = (batch if len(batch) == 5
                                       else (*batch, None))
    (logits, value), new_bs = net.forward_train(feats)
    logp = torch.log_softmax(logits, dim=-1)
    ce = (pi * logp).sum(-1)
    if pi_valid is None:
        policy_loss = -ce.mean()
    else:
        policy_loss = -(ce * pi_valid).sum() / pi_valid.sum().clamp(min=1.0)
    n_valid = z_valid.sum().clamp(min=1.0)
    value_loss = ((value - z).square() * z_valid).sum() / n_valid
    # logged always; a loss term only under sgd (Adam decays instead)
    sgd = train_cfg.optimizer == "sgd"
    with torch.set_grad_enabled(sgd and torch.is_grad_enabled()):
        l2_loss = train_cfg.l2_coef * _l2_of_kernels(net)
    loss = policy_loss + train_cfg.value_loss_weight * value_loss
    if sgd:
        loss = loss + l2_loss
    with torch.no_grad():
        log_pi = torch.log(pi.clamp(min=1e-10))
        kl = torch.where(pi > 0, pi * (log_pi - logp), 0.0).sum(-1).mean()
        aux = {
            "loss": loss.detach(),
            "policy_loss": policy_loss.detach(),
            "value_loss": value_loss.detach(),
            "l2_loss": l2_loss.detach(),
            "kl_pi_p": kl,
            "value_mae": ((value - z).abs() * z_valid).sum() / n_valid,
            "entropy_pi": -torch.where(pi > 0, pi * log_pi, 0.0)
            .sum(-1).mean(),
        }
    return loss, (new_bs, aux)


@torch.no_grad()
def optimizer_update(cfg: TrainConfig, st: OptState, params, is_kernel,
                     grads, lr_scale: torch.Tensor):
    """The optax chain's update for `params` from `grads` (lists in the
    order of `st`'s moments; `is_kernel` marks the decayed ones), × the
    lr multiplier `lr_scale`, advancing `st` in place. Returns (updates,
    the pre-clip global norm of `grads`); the caller adds the updates."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    # optax: t / norm above the limit (× max_norm = 1), t below it
    g = torch._foreach_div(grads, torch.where(norm < CLIP_NORM, 1.0, norm))
    lr = learning_rate(cfg, st.count)
    if cfg.optimizer == "sgd":
        torch._foreach_mul_(st.mu, cfg.momentum)
        torch._foreach_add_(st.mu, g)
        u = torch._foreach_mul(st.mu, -lr)
    else:
        torch._foreach_mul_(st.mu, ADAM_B1)
        torch._foreach_add_(st.mu, g, alpha=1 - ADAM_B1)
        torch._foreach_mul_(st.nu, ADAM_B2)
        torch._foreach_addcmul_(st.nu, g, g, value=1 - ADAM_B2)
        # bias corrections in f32, as optax takes them: 1 - f32(0.999) is
        # 1.3e-5 off 1 - 0.999
        f32 = np.float32
        n = f32(st.count + 1)
        u = torch._foreach_div(st.mu, float(f32(1) - f32(ADAM_B1) ** n))
        den = torch._foreach_div(st.nu, float(f32(1) - f32(ADAM_B2) ** n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        torch._foreach_div_(u, den)
        if any(is_kernel):
            torch._foreach_add_([x for x, k in zip(u, is_kernel) if k],
                                [p for p, k in zip(params, is_kernel) if k],
                                alpha=cfg.l2_coef)
        torch._foreach_mul_(u, -lr)
    st.count += 1
    torch._foreach_mul_(u, lr_scale)
    return u, norm


def check_finite(named) -> None:
    """Raise ``FloatingPointError`` naming the first of the (name,
    tensor) pairs `named` that holds a NaN or an infinity (one device
    read for all of them)."""
    named = list(named)
    ok = trace.read_list("check_finite", torch.stack(
        [torch.isfinite(t).all() for _, t in named]))
    if not all(ok):
        raise FloatingPointError(f"non-finite {named[ok.index(False)][0]}")


def train_step(env_cfg: EnvConfig, net_cfg: NetConfig,
               train_cfg: TrainConfig, ts: TrainState, batch, group=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One learner step on `batch`, in place on `ts`; returns `ts` and
    the aux metrics (0-dim tensors) with ``grad_norm`` (the pre-clip
    global norm) and ``lr_scale``.

    With a process `group` the gradients, the updated batch-norm running
    statistics and the aux metrics are averaged over its ranks in one
    all-reduce before the clip, where JAX's ``train_step`` pmeans them:
    ``grad_norm``, the clip and the update read the averaged gradients,
    so every rank applies the same update. The forward normalises by the
    rank's own batch statistics (flax's ``BatchNorm`` has no axis name):
    neither ``SyncBatchNorm`` nor DDP, whose buffer broadcast copies rank
    0's statistics where JAX averages them.

    Under ``torch.autograd``'s anomaly mode (``cli --debug-nans``) a
    non-finite loss, or averaged gradient, raises ``FloatingPointError``
    naming it."""
    params = list(ts.net.parameters())
    debug = torch.is_anomaly_enabled()
    loss, (new_bs, aux) = loss_fn(ts.net, batch, train_cfg)
    if debug:
        check_finite([("loss", loss)])
    grads = list(torch.autograd.grad(loss, params))
    if group is not None:
        from alphafive_tpu_torch.parallel.distributed import all_reduce_mean
        stats = [t for pair in new_bs for t in pair]
        keys = list(aux)
        out = all_reduce_mean(grads + stats + [aux[k] for k in keys], group)
        n, m = len(grads), len(grads) + len(stats)
        grads = out[:n]
        new_bs = list(zip(out[n:m:2], out[n + 1:m:2]))
        aux = dict(zip(keys, out[m:]))
    if debug:
        check_finite((f"gradient of {name}", g) for (name, _), g in
                     zip(ts.net.named_parameters(), grads))
    kernels = {id(k) for k in ts.net.kernels()}
    updates, aux["grad_norm"] = optimizer_update(
        train_cfg, ts.opt_state, params, [id(p) in kernels for p in params],
        grads, ts.lr_scale)
    with torch.no_grad():
        torch._foreach_add_(params, updates)
    aux["lr_scale"] = ts.lr_scale.clone()
    ts.net.set_batch_stats(new_bs)
    ts.step += 1
    return ts, aux


def adapt_lr_scale(ts: TrainState, kl: torch.Tensor, kl_target: float,
                   scale_max: float = 10.0) -> TrainState:
    """Shrink the lr multiplier by 1.5 when the update moved the policy
    too far (KL > 2·target), grow it by 1.5 when it barely moved (KL <
    target/2), clamped to [0.1, scale_max]. On the device: no host read."""
    factor = torch.where(kl > kl_target * 2, 1.0 / 1.5,
                         torch.where(kl < kl_target / 2, 1.5, 1.0))
    ts.lr_scale = torch.clamp(ts.lr_scale * factor.to(ts.lr_scale.dtype),
                              0.1, scale_max)
    return ts
