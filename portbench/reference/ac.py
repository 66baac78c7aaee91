"""The actor-critic family's update in plain PyTorch: advantage actor-critic
(IA2C, MAA2C) and its clipped-surrogate epochs (IPPO, MAPPO).

The published equations (the MARL book codebase's ia2c, maa2c, ippo and
mappo presets):

- each agent has its own actor and critic (no parameter sharing; every leaf
  carries a leading agent axis). A recurrent network is `qnet.q_values`'s:
  x = relu(obs @ W1 + b1), a GRU from a zero hidden state, y = h @ W2 + b2;
  a feed-forward one is Linear layers with relu between. The actor gives
  logits over the agent's actions; the critic one value. A centralised
  critic takes every agent's observation of the env, joined in agent order;
  an independent one the agent's own.
- n-step returns from a target critic V' over the T+1 states:
  R_t = sum_{s<n, t+s<T} gamma^s r_{t+s} (1 - d_{t+s}) + [t+n < T] gamma^n
  V'_{t+n} (1 - d_{t+n}), d_t "state t is terminal" (the rollout's dones).
- the loss of a rollout, with A_t = R_t - V_t (the advantage; no gradient
  into the actor through it), summed over agents and averaged over the
  filled (t, e) cells of the whole rollout:
  actor: -(objective) - c_ent * entropy, with objective log pi(a_t) A_t
  (A2C) or min(rho A_t, clip(rho, 1 - eps, 1 + eps) A_t), rho = pi(a_t) /
  pi_old(a_t) with pi_old the actor before the update (PPO); value: c_v
  A_t^2. Masked actions (an env that masks them) take the logit -1e8.
- A2C takes one Adam step; PPO `num_epochs` full-batch steps on the same
  rollout; Adam b1 0.9, b2 0.999, eps 1e-8, no gradient clip.

The loss is a sum over rows divided by the whole rollout's filled count, so
it and its gradient add over blocks of envs: `follow` takes the update in
blocks of `block_envs` envs, each on the device only while it is formed.

`precision`: `qnet.F32` forms every product in float32 with TF32 off;
`qnet.TF32` rounds the inputs of every product to TF32 first, the next
precision down: the control that the comparison has to fail.
"""

from __future__ import annotations

import torch

from portbench.reference import qnet

F32, TF32 = qnet.F32, qnet.TF32
MASK_NEG = -1e8


def network(p, x, precision=F32):
    """p: a recurrent tree {first, rnn, final} or a feed-forward {layers},
    leading agent axis; x (N, T, B, D) -> (N, T, B, out)."""
    if "rnn" in p:
        return qnet.q_values(p, x, precision)
    N, T, B, _ = x.shape
    y = x.reshape(N, T * B, -1)
    for i, layer in enumerate(p["layers"]):
        y = qnet.linear(y, layer["w"], layer["b"], precision)
        if i < len(p["layers"]) - 1:
            y = torch.relu(y)
    return y.reshape(N, T, B, -1)


def critic_inputs(obs, centralised: bool):
    """obs (N, T, B, D) -> each agent's critic input: its own, or (N, T,
    B, N*D) every agent's joined in agent order."""
    if not centralised:
        return obs
    N, T, B, D = obs.shape
    joint = obs.permute(1, 2, 0, 3).reshape(T, B, N * D)
    return joint.unsqueeze(0).expand(N, T, B, N * D)


def values(pc, obs, centralised: bool, precision=F32):
    """The critic's values (T, B, N) of obs (N, T, B, D)."""
    return network(pc, critic_inputs(obs, centralised), precision)[..., 0].permute(1, 2, 0)


def masked(logits, mask):
    """logits * mask + (1 - mask) * -1e8; no mask leaves the logits."""
    return logits if mask is None else logits * mask + (1.0 - mask) * MASK_NEG


def nstep_returns(rewards, dones, next_values, n: int, gamma: float):
    """rewards (T, B, N), dones (T+1, B), next_values (T+1, B, N) -> (T, B,
    N), by the equation in the module's docstring."""
    T = rewards.shape[0]
    live = 1.0 - dones[:, :, None]  # (T+1, B, 1)
    out = torch.zeros_like(rewards)
    for t in range(T):
        acc = torch.zeros_like(rewards[0])
        for s in range(n):
            if t + s < T:
                acc = acc + gamma**s * (rewards[t + s] * live[t + s])
        if t + n < T:
            acc = acc + gamma**n * (next_values[t + n] * live[t + n])
        out[t] = acc
    return out


def log_probs_entropy(pa, obs, actions, mask=None, precision=F32):
    """obs (N, T, B, D), actions (T, B, N), mask (N, T, B, A) or None ->
    (log-probs (T, B, N), entropy summed over agents (T, B), probabilities
    (N, T, B, A))."""
    logp = torch.log_softmax(masked(network(pa, obs, precision), mask), -1)
    lp = logp.gather(-1, actions.permute(2, 0, 1).unsqueeze(-1)).squeeze(-1).permute(1, 2, 0)
    p = torch.exp(logp)
    ent = -torch.where(p > 0, p * logp, torch.zeros_like(logp)).sum(-1).sum(0)
    return lp, ent, p


def block_loss(params, spec, obs, actions, returns, filled, old_lp=None, mask=None, precision=F32):
    """The rollout loss's sum over one block's rows (divide by the whole
    rollout's filled count), and the sum of the rows' magnitudes (no
    gradient): obs (N, T, B, D) the states acted in, actions and returns
    (T, B, N), filled (T, B), old_lp (T, B, N) for PPO."""
    v = values(params["critic"], obs, spec["centralised_critic"], precision)
    lp, ent, _ = log_probs_entropy(params["actor"], obs, actions, mask, precision)
    adv = returns - v
    a = adv.detach()
    if spec["ppo"]:
        ratio = torch.exp(lp - old_lp)
        clip = spec["ppo_clip"]
        objective = torch.minimum(ratio * a, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * a)
    else:
        objective = lp * a
    actor = (-objective.sum(-1) - spec["entropy_coef"] * ent) * filled
    value = (adv**2).sum(-1) * filled
    rows = actor + spec["value_loss_coef"] * value
    return actor.sum() + spec["value_loss_coef"] * value.sum(), rows.detach().abs().sum()


def tree_leaves(tree):
    """The leaves of a nested dict/list tree, dicts in sorted key order (the
    program's leaf order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def on_device(tree, device):
    """A copy of a tree of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [on_device(v, device) for v in tree]
    return tree.to(device, copy=True)


def _host(t):
    return t.detach().to("cpu", copy=True)


def _blocks(E: int, size: int):
    return [(s, min(s + size, E)) for s in range(0, E, size)]


def follow(w0, rollout, spec, device, precision=F32, half_batch=False, block_envs=None):
    """The update of one rollout from the seed's weights `w0` ({"actor",
    "critic"} trees on the host), on `device`, block by block of envs.

    `rollout` (host tensors): obs (N, T+1, E, D), actions, rewards (T, E,
    N), dones (T+1, E), filled (T, E), action_mask (N, T+1, E, A) or None.
    `half_batch` is a planted fault: the update over the first half of the
    envs only.

    Returns {"returns" (T, E, N), "losses" [one an epoch], "scales" (each
    epoch's mean magnitude of a filled row's loss), "first_grad" and
    "after" (leaves in the program's order, `tree_leaves`), "samples" (the
    rollout's actions against the probabilities of the actor before the
    update, `sample_counts`)}, on the host."""
    E = rollout["filled"].shape[1]
    if half_batch:
        E //= 2
    block_envs = int(block_envs or spec.get("block_envs", E))
    params = on_device(w0, device)
    target = on_device(w0["critic"], device)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = qnet.Adam(leaves, spec["lr"], float("inf"))  # no clip

    def block(lo, hi):
        obs = rollout["obs"][:, :, lo:hi].to(device)
        mask = rollout.get("action_mask")
        return {"obs_all": obs, "obs": obs[:, :-1], "mask": None if mask is None else mask[:, :-1, lo:hi].to(device),
                "actions": rollout["actions"][:, lo:hi].to(device), "filled": rollout["filled"][:, lo:hi].to(device)}

    returns, old_lp, samples = [], [], None
    with torch.no_grad():
        for lo, hi in _blocks(E, block_envs):
            b = block(lo, hi)
            nv = values(target, b["obs_all"], spec["centralised_critic"], precision)
            returns.append(nstep_returns(rollout["rewards"][:, lo:hi].to(device), rollout["dones"][:, lo:hi].to(device),
                                         nv, spec["n_steps"], spec["gamma"]))
            lp, _, probs = log_probs_entropy(params["actor"], b["obs"], b["actions"], b["mask"], precision)
            old_lp.append(lp)
            part = sample_counts(probs, b["actions"], b["filled"])
            samples = part if samples is None else {k: samples[k] + part[k] for k in part}
    fsum = float(rollout["filled"][:, :E].sum().clamp(min=1.0))
    losses, scales, first_grad = [], [], None
    for _ in range(int(spec["num_epochs"]) if spec["ppo"] else 1):
        grads = [torch.zeros_like(t) for t in leaves]
        total = scale = 0.0
        for k, (lo, hi) in enumerate(_blocks(E, block_envs)):
            b = block(lo, hi)
            loss, size = block_loss(params, spec, b["obs"], b["actions"], returns[k], b["filled"],
                                    old_lp[k] if spec["ppo"] else None, b["mask"], precision)
            for g, d in zip(grads, torch.autograd.grad(loss / fsum, leaves)):
                g += d
            total += float(loss.detach()) / fsum
            scale += float(size) / fsum
        opt.step(leaves, grads)
        losses.append(total)
        scales.append(scale)
        if first_grad is None:
            first_grad = [_host(g) for g in grads]
    return {"returns": torch.cat([_host(r) for r in returns], 1), "losses": losses, "scales": scales,
            "first_grad": first_grad,
            "after": [_host(t) for t in leaves], "samples": {k: _host(v) for k, v in samples.items()}}


def sample_counts(probs, actions, filled):
    """Over the filled (t, e) cells, per agent and action: the count of the
    draws, the sum of the probabilities and the sum of p (1 - p), the
    variance of the count. probs (N, T, B, A), actions (T, B, N), filled
    (T, B)."""
    f = filled[None, :, :, None]  # (1, T, B, 1)
    onehot = torch.nn.functional.one_hot(actions.permute(2, 0, 1), probs.shape[-1]).to(probs.dtype)
    return {"drawn": (onehot * f).sum((1, 2)).double(), "expected": (probs * f).sum((1, 2)).double(),
            "variance": (probs * (1.0 - probs) * f).sum((1, 2)).double()}


def sample_gap(samples) -> float:
    """The largest |count - expected count| of any agent's action, in
    standard errors (sqrt of the summed p (1 - p)); 0 where no action has
    a variance."""
    var = samples["variance"]
    live = var > 0
    if not bool(live.any()):
        return 0.0
    z = (samples["drawn"] - samples["expected"]).abs()[live] / var[live].sqrt()
    return float(z.max())
