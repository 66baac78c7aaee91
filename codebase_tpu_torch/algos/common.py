"""Shared training utilities: the optimizers, target-network updates and the
early-exit option of the episode collector."""

from __future__ import annotations

import numpy as np
import torch

from codebase_tpu_torch.utils import checkpoint as ckpt
from codebase_tpu_torch.utils.params import tree_leaves, tree_unflatten


class Optimizer:
    """A gradient step after a global-norm clip, with the JAX package's exact
    rules (`optax.chain(optax.clip_by_global_norm(c), <rule>)`). The
    subclasses are the rules: `Adam`, `AdamW`, `RMSProp` and `SGD`.

    - clip: with `n = sqrt(sum_i |g_i|^2)` over all leaves, every gradient
      becomes `g` when `n < c`, else `(g / n) * c`. This is not
      `torch.nn.utils.clip_grad_norm_`, which scales by `c / (n + 1e-6)`.
      `clip_mask` (one bool per parameter, or None for all) restricts both
      the norm and the scaling to the masked leaves; the others pass
      unclipped (`optax.masked(clip_by_global_norm(c), mask)`). QMIX clips
      the critic only, as the reference's `clip_grad_norm_(critic.parameters())`
      does: whole-tree clipping changed QMIX's learning in the JAX package.
      The actor-critic family runs one optimizer over the whole {"actor",
      "critic"} tree, and a clip there covers every leaf;
    - the rule's direction `d` (`_direction`), then `p <- p - lr * d`.

    `n_units` > 1 runs one optimizer per unit of a sweep over parameters
    whose leading axis is unit-major (`leaf.view(U, -1)` is unit u's row u):
    `lr` may then be one value per unit, and the clip norm, the step count
    and the bias corrections are each unit's own, as `jax.vmap` over optax
    gives them. `step(grads, active)` moves only the active units (a unit
    that may not train yet takes no step and keeps its count and moments).
    One unit keeps the scalar arithmetic, `lr` and `count` of a plain run.

    The clip decision stays on the device (`torch.where`), so a step never
    waits for the host. Parameters and moments are updated in place.

    `state_dict` writes the state in the layout of the JAX package's
    checkpoint for the same optimizer, flax's state dict of its optax chain,
    and `load_state_dict` reads it back from a checkpoint of either package.
    """

    moments = ()  # the names of the per-parameter state tensors
    # the rule's optax chain: its number of transformations (the first holds
    # the moments) and whether that first state carries the step count
    chain_length = 2
    counted = False

    def __init__(self, params, lr, grad_clip=None, clip_mask=None, n_units=1):
        self.params = list(params)
        self.n_units = int(n_units)
        self.lr = pack_units(unit_values(lr, self.n_units, np.float64))
        self.grad_clip = float(grad_clip) if grad_clip else None
        self.masked_clip = clip_mask is not None
        self.clip_mask = [True] * len(self.params) if clip_mask is None else [bool(m) for m in clip_mask]
        if len(self.clip_mask) != len(self.params):
            raise ValueError(f"clip_mask has {len(self.clip_mask)} entries for {len(self.params)} parameters")
        for name in self.moments:
            setattr(self, name, [torch.zeros_like(p) for p in self.params])
        self.count = pack_units(np.zeros(self.n_units, np.int64))

    def _corrections(self, counts):
        """Per-step values the rule needs beside the gradients (Adam's bias
        corrections), from each unit's step count."""
        return None

    def _direction(self, g, p, moments, corr):
        """(the moments' new values, the direction d) for one parameter, each
        (U, -1): the update is `p - lr * d`."""
        raise NotImplementedError

    def _unit_tensor(self, values, dtype=None):
        """Per-unit values as a (U, 1) tensor on the parameters' device."""
        return torch.tensor(values, dtype=dtype, device=self.params[0].device)[:, None]

    def state_dict(self, param_tree) -> dict:
        """`{"0": <the first transformation's state>, "1": {}, ...}`, each
        moment nested as `param_tree` (whose `tree_leaves` order the moments
        follow), inside `{"0": <the clip's state>, "1": ...}` when the
        gradients are clipped (`{}`, or `{"inner_state": {}}` for a clip
        masked to the critic). One unit only: a sweep does not checkpoint."""
        first = {name: ckpt.params_state_dict(tree_unflatten(param_tree, getattr(self, name)))
                 for name in self.moments}
        if self.counted:
            first["count"] = ckpt.counter(self.count)
        chain = {str(i): {} for i in range(self.chain_length)}
        chain["0"] = first
        if self.grad_clip is None:
            return chain
        return {"0": {"inner_state": {}} if self.masked_clip else {}, "1": chain}

    def load_state_dict(self, param_tree, state_dict) -> None:
        """Restore the state from `state_dict`'s layout, in place."""
        first = (state_dict["1"] if self.grad_clip is not None else state_dict)["0"]
        if self.counted:
            self.count = int(first["count"])
        for name in self.moments:
            ckpt.load_leaves(getattr(self, name), tree_leaves(ckpt.tree_from_state_dict(param_tree, first[name])))

    @torch.no_grad()
    def step(self, grads, active=None) -> None:
        U = self.n_units
        active = np.ones(U, bool) if active is None else np.asarray(active, bool).reshape(U)
        if not active.any():
            return
        grads = [g.reshape(U, -1) for g in grads]
        if self.grad_clip is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g, dim=1) for g, m in zip(grads, self.clip_mask) if m))[:, None]
            keep = g_norm < self.grad_clip
            grads = [
                torch.where(keep, g, (g / g_norm) * self.grad_clip) if m else g
                for g, m in zip(grads, self.clip_mask)
            ]
        counts = unit_values(self.count, U) + active
        self.count = pack_units(counts)
        corr = self._corrections(counts)
        lr = unit_values(self.lr, U, np.float64)
        if U == 1:
            neg_lr, live = -float(lr[0]), None
        else:
            neg_lr = self._unit_tensor(-lr, self.params[0].dtype)
            live = None if active.all() else self._unit_tensor(active)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            p = p.view(U, -1)
            olds = [getattr(self, name)[i].view(U, -1) for name in self.moments]
            news, d = self._direction(g, p, olds, corr)
            for old, new in zip(olds, news):
                old.copy_(new if live is None else torch.where(live, new, old))
            if U == 1:
                p.add_(d, alpha=neg_lr)
            elif live is None:
                p.add_(d * neg_lr)
            else:
                p.copy_(torch.where(live, p + d * neg_lr, p))


class Adam(Optimizer):
    """optax's `adam` (torch-default hyperparameters b1=0.9, b2=0.999,
    eps=1e-8): `mu = (1-b1) g + b1 mu`, `nu = (1-b2) g^2 + b2 nu`, and the
    direction `(mu / (1-b1^k)) / (sqrt(nu / (1-b2^k)) + eps)` at step k."""

    moments = ("mu", "nu")
    counted = True

    def __init__(self, params, lr, grad_clip=None, b1=0.9, b2=0.999, eps=1e-8, clip_mask=None, n_units=1):
        self.b1, self.b2, self.eps = b1, b2, eps
        super().__init__(params, lr, grad_clip, clip_mask, n_units)

    def _corrections(self, counts):
        # optax forms the bias corrections in the default float type: 1 -
        # f32(b)**count for float32 parameters, float64 where JAX runs in
        # 64-bit mode
        f = np.float64 if self.params[0].dtype == torch.float64 else np.float32
        bc1 = np.array([f(1.0) - f(self.b1) ** f(c) for c in counts])
        bc2 = np.array([f(1.0) - f(self.b2) ** f(c) for c in counts])
        if self.n_units == 1:
            return float(bc1[0]), float(bc2[0])
        return self._unit_tensor(bc1), self._unit_tensor(bc2)

    def _direction(self, g, p, moments, corr):
        mu, nu = moments
        bc1, bc2 = corr
        new_mu = (1.0 - self.b1) * g + self.b1 * mu
        new_nu = (1.0 - self.b2) * (g * g) + self.b2 * nu
        return (new_mu, new_nu), (new_mu / bc1) / (torch.sqrt(new_nu / bc2) + self.eps)


class AdamW(Adam):
    """optax's `adamw` with its default weight decay 1e-4: Adam's direction
    plus `weight_decay * p` (`add_decayed_weights`, on every leaf), both
    scaled by the learning rate."""

    chain_length = 3

    def __init__(self, params, lr, grad_clip=None, weight_decay=1e-4, clip_mask=None, n_units=1):
        self.weight_decay = weight_decay
        super().__init__(params, lr, grad_clip, clip_mask=clip_mask, n_units=n_units)

    def _direction(self, g, p, moments, corr):
        news, d = super()._direction(g, p, moments, corr)
        return news, d + self.weight_decay * p


class RMSProp(Optimizer):
    """optax's `rmsprop` as the JAX package builds it (decay 0.99, eps 1e-8,
    no centering or momentum): `nu = (1-decay) g^2 + decay nu`, nu starting
    at 0, and the direction `g / sqrt(nu + eps)` (eps inside the root, not
    torch.optim.RMSprop's `sqrt(nu) + eps`)."""

    moments = ("nu",)
    chain_length = 3

    def __init__(self, params, lr, grad_clip=None, decay=0.99, eps=1e-8, clip_mask=None, n_units=1):
        self.decay, self.eps = decay, eps
        super().__init__(params, lr, grad_clip, clip_mask, n_units)

    def _direction(self, g, p, moments, corr):
        new_nu = (1.0 - self.decay) * (g * g) + self.decay * moments[0]
        return (new_nu,), g * torch.rsqrt(new_nu + self.eps)


class SGD(Optimizer):
    """optax's plain `sgd`: the direction is the gradient."""

    def _direction(self, g, p, moments, corr):
        return (), g


OPTIMIZERS = {"adam": Adam, "adamw": AdamW, "rmsprop": RMSProp, "sgd": SGD}


def make_optimizer(name: str, params, lr, grad_clip=False, clip_mask=None, n_units=1) -> Optimizer:
    """The JAX package's optimizers by name: adam, adamw, rmsprop, sgd."""
    key = str(name).lower()
    if key not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; choose from {sorted(OPTIMIZERS)}")
    return OPTIMIZERS[key](params, lr, grad_clip, clip_mask=clip_mask, n_units=n_units)


# --------------------------------------------------------------- sweep units
# The units of a sweep (one hyperparameter variant and seed each) train
# together: every per-unit tensor carries a leading unit axis, folded into
# the agent (group) axis for the networks. A state of one unit keeps the
# layout of a plain run: scalar counters and hyperparameters, no unit axis.


def unit_values(x, n_units: int, dtype=np.int64) -> np.ndarray:
    """A counter or host hyperparameter as a (U,) array (a scalar is every
    unit's)."""
    return np.broadcast_to(np.asarray(x, dtype), (n_units,)).copy()


def pack_units(values: np.ndarray):
    """The inverse of `unit_values` for storage: a Python scalar for one
    unit, the (U,) array otherwise."""
    return values.item() if values.shape == (1,) else values


def unit_scalar(values, ndim: int, like: torch.Tensor):
    """Per-unit floats as an operand over tensors with a leading unit axis
    of `ndim` dimensions: a Python float for one unit (the arithmetic of a
    plain run), else a (U, 1, ..., 1) tensor of `like`'s dtype and device."""
    values = np.asarray(values, np.float64).reshape(-1)
    if values.size == 1:
        return float(values[0])
    return torch.tensor(values, dtype=like.dtype, device=like.device).reshape((-1,) + (1,) * (ndim - 1))


def unit_hypers(acfg, hypers):
    """The per-unit (U,) float64 arrays of lr, gamma and the target's tau,
    from one {"lr"|"gamma"|"tau": value} dict per unit and the config's
    defaults. The target regime (a hard copy every tau updates when the
    config's tau > 1, a Polyak update when < 1) is the config's, so a tau
    set must stay in it: ValueError otherwise, as the JAX sweep refuses."""
    hypers = [dict(h) for h in hypers]
    unknown = sorted({k for h in hypers for k in h} - {"lr", "gamma", "tau"})
    if unknown:
        raise ValueError(f"per-unit hyperparameters are lr, gamma and tau; got {unknown}")
    defaults = {"lr": float(acfg.lr), "gamma": float(acfg.gamma), "tau": float(acfg.target_update_interval_or_tau)}
    values = {k: np.array([float(h.get(k, d)) for h in hypers]) for k, d in defaults.items()}
    hard = defaults["tau"] > 1.0
    if any((t > 1.0) != hard for t in values["tau"]):
        raise ValueError(
            "swept tau values must share one regime (all hard-update intervals > 1 or all Polyak "
            f"factors < 1), the config default's: got {values['tau'].tolist()} with default {defaults['tau']}"
        )
    return values["lr"], values["gamma"], values["tau"]


def early_exit_option(acfg):
    """The `rollout_early_exit` config key for `collect_episodes`: "auto"
    (the default: early exit at E >= 512 when the env can end early), or a
    forced True ("on") or False ("off"). Both give identical rollouts
    (`envs/vector.py`)."""
    opt = acfg.get("rollout_early_exit", "auto")
    if opt in ("auto", None):
        return "auto"
    if opt in ("on", True, "true"):
        return True
    if opt in ("off", False, "false"):
        return False
    raise ValueError(f"rollout_early_exit must be auto/on/off, got {opt!r}")


def _live_units(units, like: torch.Tensor):
    """None when every unit updates (`units` None or all True), else a
    (U, 1) bool tensor of the units that do."""
    if units is None or np.all(units):
        return None
    return torch.tensor(np.asarray(units, bool), device=like.device)[:, None]


@torch.no_grad()
def hard_update(target_params, source_params, units=None) -> None:
    """target <- source; with `units` (a host bool per unit of a leading
    unit axis), only the units marked True."""
    if units is not None and not np.any(units):
        return
    live = _live_units(units, target_params[0])
    for t, s in zip(target_params, source_params):
        if live is None:
            t.copy_(s)
        else:
            tv = t.view(len(live), -1)
            tv.copy_(torch.where(live, s.view(len(live), -1), tv))


@torch.no_grad()
def soft_update(target_params, source_params, tau, units=None) -> None:
    """Polyak update: target <- (1 - tau) * target + tau * source. `tau` is
    a float, or a (U, 1) tensor of per-unit values over a leading unit
    axis; `units` (host bools) limits the update to the units marked True."""
    if units is not None and not np.any(units):
        return
    live = _live_units(units, target_params[0])
    for t, s in zip(target_params, source_params):
        if live is None and not isinstance(tau, torch.Tensor):
            t.copy_((1.0 - tau) * t + tau * s)
            continue
        U = len(tau) if isinstance(tau, torch.Tensor) else len(live)
        tv, sv = t.view(U, -1), s.view(U, -1)
        new = (1.0 - tau) * tv + tau * sv
        tv.copy_(new if live is None else torch.where(live, new, tv))
