"""What decides `correct`: the taps on the first train iteration, and the
comparison of what they recorded with the plain reference.

Set-up drives the train state through its first iteration with the same
call the window makes (`train_iteration(state)`), with taps that record and
change nothing:

- a forward hook on the online critic keeps the Q-values the rollout's
  policy formed (the GRU kernels at T=1, step by step) for a sample of envs
  drawn from the seed;
- the model's `unit_losses` is wrapped for that iteration: it keeps each
  of the first three updates' batch (as the update got it) and loss, the
  optimizer's first moments after the first step (the first gradient as
  Adam got it, clipped: `mu / (1 - b1)`), and the parameters after the third
  step, read at the start of the fourth;
- the env's `reset_batch` is wrapped for that iteration: it keeps every
  env's reset state (SMAClite's state is not in its observations);
- after the iteration, the replay slots that the rollout filled are read
  back for the sampled envs, with the target network's parameters.

Once the window has closed, the reference (`reference/`) replays the
sampled episodes, of the rollout and of each recorded batch, through the
env's rules, forms the Q-values from the seed's weights, and takes three
updates from the seed's weights on the recorded batches, and the numbers
below are compared with their limits (the configuration file's):

- `env_mismatch`: entries of the sampled episodes (obs, rewards, dones,
  filled, padding), rollout and batch rows, that the rules do not give; 0.
- `reset_faults`: first observations that break the reset's rules; 0.
- `q_gap`: the widest gap between the program's rollout Q-values and the
  reference's, over the filled steps, in units of the reference's RMS.
- `loss_gap`: the widest relative gap of the first three updates' losses.
- `grad_gap`: the widest gap, over the leaves, between the norms of the
  first (clipped) gradient, over the larger of the reference leaf's norm
  and the median leaf's.
- `change_gap`: the same for the norm of each leaf's change over the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).
- `target_moved`: target parameters that differ from the seed's weights
  after the first iteration (no hard copy is due before update 200); 0.

`run.py` adds two exact numbers of the hard target copy, read after the
window (`Cell.target_copies`): `target_schedule` and `target_copy_gap`; 0.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench.reference import lbf as ref_lbf
from portbench.reference import qnet
from portbench.reference import smaclite as ref_smaclite

# the sampled envs, and the sampled rows of each followed batch, unless the
# configuration's reference sets `check_rows`
CHECK_ENVS = 256
FOLLOWED_UPDATES = 3


def seed_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one of the harness's own streams of `seed`, apart
    from the program's generator (seeded with `seed` itself)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % (2**63))


def tree_items(tree, prefix=""):
    """(path, tensor) pairs of a nested dict/list tree, dicts in sorted key
    order (the order of the program's `tree_leaves`)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def weight_bounds(tree, out=None):
    """The bound of each leaf's uniform draw: 1/sqrt(fan in) of its layer
    (a GRU layer's every leaf 1/sqrt(H)), torch's defaults."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        if "w_hh" in tree:
            bound = 1.0 / math.sqrt(tree["w_hh"].shape[-2])
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                out[id(tree[k])] = bound
        elif "w" in tree and "b" in tree:
            bound = 1.0 / math.sqrt(tree["w"].shape[-2])
            out[id(tree["w"])] = out[id(tree["b"])] = bound
        else:
            for v in tree.values():
                weight_bounds(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            weight_bounds(v, out)
    return out


@torch.no_grad()
def make_weights(model_tree, target_tree, seed: int, device):
    """Fill the program's parameters (online and target alike) with weights
    drawn on the device from the seed, in one draw; returns the weights as
    a tree of CPU tensors that the reference starts from."""
    leaves = list(tree_items(model_tree))
    bounds = weight_bounds(model_tree)
    total = sum(t.numel() for _, t in leaves)
    u = torch.rand(total, generator=seed_generator(seed, 1, device), device=device)
    start, flat = 0, {}
    for path, t in leaves:
        n = t.numel()
        flat[path] = ((2.0 * u[start:start + n] - 1.0) * bounds[id(t)]).view(t.shape)
        start += n
    for path, t in tree_items(model_tree):
        t.copy_(flat[path])
    for path, t in tree_items(target_tree):
        t.copy_(flat[path])
    return unflatten(model_tree, {p: host(v) for p, v in flat.items()})


def unflatten(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: unflatten(tree[k], flat, f"{prefix}/{k}") for k in tree}
    if isinstance(tree, (list, tuple)):
        return [unflatten(v, flat, f"{prefix}[{i}]") for i, v in enumerate(tree)]
    return flat[prefix]


def host(t: torch.Tensor) -> torch.Tensor:
    """A copy on the host (never a view of the device tensor or of a CPU
    tensor that the program goes on changing)."""
    return t.detach().to("cpu", copy=True)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device, copy=True)


class Taps:
    """Records the first train iteration (see the module's docstring)."""

    def __init__(self, state, env, n_envs: int, seed: int, check_rows: int = CHECK_ENVS):
        self.state, self.env = state, env
        rng = np.random.default_rng(int(seed))
        self.check_rows = check_rows
        self.envs = np.sort(rng.choice(n_envs, size=min(check_rows, n_envs), replace=False))
        self.rng = rng
        self.n_envs = n_envs
        self.q = []  # the rollout's Q-values of the sampled envs, one (N, K, A) a step
        self.batches, self.losses = [], []
        self.first_moments = None
        self.params_after = None
        self.resets = None  # the first rollout's reset states, every env's
        self.calls = 0

    def __enter__(self):
        state = self.state
        self._idx = torch.as_tensor(self.envs, device=state.buffer.obs.device)
        self._hook = state.model.critic.register_forward_hook(self._on_critic)
        self._unit_losses = state.model.unit_losses
        state.model.unit_losses = self._on_unit_losses
        self._reset_batch = self.env.reset_batch
        object.__setattr__(self.env, "reset_batch", self._on_reset)  # the env spec is a frozen dataclass
        return self

    def __exit__(self, *exc):
        self._hook.remove()
        del self.state.model.unit_losses
        object.__delattr__(self.env, "reset_batch")
        return False

    def _on_reset(self, generator, n):
        state, ts = self._reset_batch(generator, n)
        if self.resets is None:
            inner = self.env.inner_state(state)
            self.resets = {k: host(v) for k, v in vars(inner).items() if isinstance(v, torch.Tensor)}
        return state, ts

    def _on_critic(self, module, args, output):
        x = args[0]  # (N, T, E, D)
        if self.calls == 0 and x.shape[1] == 1 and x.shape[2] == self.n_envs:
            self.q.append(output[0][:, 0].index_select(1, self._idx).detach().clone())

    @torch.no_grad()
    def _on_unit_losses(self, target, batch, ret_rms, shard=None):
        k = self.calls
        self.calls += 1
        opt = self.state.opt
        if k == 1:
            self.first_moments = [host(m) / (1.0 - opt.b1) for m in opt.mu]
        if k == FOLLOWED_UPDATES:
            self.params_after = [host(p) for p in self.state.model.param_leaves()]
        with torch.enable_grad():
            losses, rms = self._unit_losses(target, batch, ret_rms, shard)
        if k < FOLLOWED_UPDATES:
            self.batches.append({key: (None if v is None else host(v)) for key, v in batch.items()})
            self.losses.append(losses.detach().clone())
        return losses, rms

    def finish(self):
        """After the iteration: the sampled envs' replay slots (the first
        insert fills slots 0..E-1 with envs 0..E-1), the target's
        parameters, everything on the host."""
        buf = self.state.buffer
        idx = self._idx
        self.rollout = {
            "obs": host(buf.obs.index_select(0, idx).float()),
            "actions": host(buf.actions.index_select(0, idx)),
            "rewards": host(buf.rewards.index_select(0, idx)),
            "dones": host(buf.dones.index_select(0, idx)),
            "filled": host(buf.filled.index_select(0, idx)),
            "action_mask": None if buf.action_mask is None else host(buf.action_mask.index_select(0, idx).float()),
        }
        self.q = host(torch.stack(self.q)) if self.q else None  # (T, N, K, A)
        self.losses = [float(x.sum()) for x in self.losses]
        rows = self.check_rows
        self.batch_rows = [np.sort(self.rng.choice(b["filled"].shape[-1], size=min(rows, b["filled"].shape[-1]),
                                                   replace=False)) for b in self.batches]
        self.target_after = [host(p) for p in self.state.target.param_leaves()]
        # the program's state is the program's: nothing here keeps it alive
        self.state = self.env = self._idx = self._hook = self._unit_losses = self._reset_batch = None
        if len(self.batches) < FOLLOWED_UPDATES or self.params_after is None:
            raise RuntimeError(f"the first iteration made {self.calls} updates; the check follows "
                               f"{FOLLOWED_UPDATES} and reads the parameters at the start of the next")


def _worst_leaf_gap(prog, ref, keep=None):
    """max over leaves of |prog - ref| / max(ref, median(ref))."""
    med = statistics.median(ref)
    gaps = [abs(p - r) / max(r, med, 1e-30) for i, (p, r) in enumerate(zip(prog, ref))
            if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def _batch_rows(batch, rows):
    """Episode-major rows of a reference-layout batch, for the env check."""
    pick = torch.as_tensor(rows)
    return {
        "obs": batch["obss"][:, :, pick].permute(2, 1, 0, 3).numpy(),
        "actions": batch["actions"][:, :, pick].permute(2, 1, 0).numpy(),
        "rewards": batch["rewards"][:, :, pick].permute(2, 1, 0).numpy(),
        "dones": batch["dones"][:, pick].T.numpy(),
        "filled": batch["filled"][:, pick].T.numpy(),
        "action_mask": (None if batch.get("action_mask") is None
                        else batch["action_mask"][:, :, pick].permute(2, 1, 0, 3).numpy()),
    }


def env_numbers(taps: Taps, env: dict):
    """(mismatches, reset faults, first mismatch) of the sampled rollout
    episodes and batch rows against the env's rules (`reference/`)."""
    r = {k: (None if v is None else np.asarray(v)) for k, v in taps.rollout.items()}
    rows = [r] + [_batch_rows(b, pick) for b, pick in zip(taps.batches, taps.batch_rows)]
    if env["kind"] == "lbf":
        results = [ref_lbf.check_episodes(env, x["obs"], x["actions"], x["rewards"], x["dones"], x["filled"])
                   for x in rows]
    elif env["kind"] == "smaclite":
        resets = {k: v.numpy() for k, v in taps.resets.items()}

        def reset_of(e):
            return {k: v[..., e] for k, v in resets.items() if k != "t"}

        # a batch row's episode: the env whose reset put its allies where
        # the row's first observation sees them (own row and col / map size)
        key_of_env = {tuple(np.concatenate([resets["ally_r"][:, e], resets["ally_c"][:, e]])): e
                      for e in range(resets["ally_r"].shape[-1])}
        results = [ref_smaclite.check_episodes(env, r["obs"], r["actions"], r["rewards"], r["dones"], r["filled"],
                                               r["action_mask"], [reset_of(e) for e in taps.envs])]
        for x in rows[1:]:
            keys = [tuple(np.concatenate([np.rint(o[:, 2] * env["rows"]), np.rint(o[:, 3] * env["cols"])]).astype(int))
                    for o in x["obs"][:, 0]]
            found = [key_of_env.get(k) for k in keys]
            missing = sum(e is None for e in found)
            keep = [i for i, e in enumerate(found) if e is not None]
            res = ref_smaclite.check_episodes(env, *(x[k][keep] for k in ("obs", "actions", "rewards", "dones", "filled",
                                                                          "action_mask")),
                                              [reset_of(found[i]) for i in keep])
            results.append((res[0] + missing, res[1], res[2] or (f"{missing} batch rows match no episode"
                                                                if missing else None)))
    else:
        raise ValueError(f"no reference for env kind {env['kind']!r}")
    return (sum(x[0] for x in results), sum(x[1] for x in results),
            next((x[2] for x in results if x[2]), None))


def follow_updates(w0, batches, spec, device, precision, half_batch=False):
    """Three reference updates from the seed's weights on the recorded
    batches: (losses, first clipped gradient, leaves after three steps) in
    the program's leaf order. The target stays at the seed's weights."""
    params = to_device(w0, device)
    target = to_device(w0, device)
    leaves = [t for _, t in tree_items(params)]
    for t in leaves:
        t.requires_grad_(True)
    clip_mask = [p.startswith("/critic") for p, _ in tree_items(params)] if spec.get("mixer") else None
    opt = qnet.Adam(leaves, spec["lr"], spec["grad_clip"], clip_mask)
    losses, first_grad = [], None
    for b in batches:
        b = {k: (None if v is None else v.to(device)) for k, v in b.items()}
        loss = qnet.double_q_loss(params, target, b, spec["gamma"], spec.get("mixer"), precision, half_batch)
        grads = torch.autograd.grad(loss, leaves)
        clipped = opt.step(leaves, grads)
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = [host(g) for g in clipped]
    return losses, first_grad, [host(t) for t in leaves]


def judge(taps: Taps, w0, spec: dict, device, mode: str = "program"):
    """The numbers compared, for the program (`mode` "program") or for the
    reference put in its place: "control" (TF32 products) or the planted
    fault "half_batch" (the loss over half the rows). Returns {name:
    number}."""
    numbers = {}
    rollout = taps.rollout
    bad, faults, taps.env_first_mismatch = env_numbers(taps, spec["env"])
    numbers["env_mismatch"] = float(bad)
    numbers["reset_faults"] = float(faults)

    with torch.no_grad():
        obs = rollout["obs"].permute(2, 1, 0, 3).to(device)  # (N, T+1, K, D)
        q_ref = qnet.q_values(to_device(w0["critic"], device), obs, qnet.F32)[:, :-1].cpu()  # (N, T, K, A)
        if mode == "control":
            q_prog = qnet.q_values(to_device(w0["critic"], device), obs, qnet.TF32)[:, :-1].cpu()
        else:
            q_prog = taps.q.permute(1, 0, 2, 3)  # (N, T, K, A)
    T = min(q_prog.shape[1], q_ref.shape[1])
    live = rollout["filled"].T[:T].bool()  # (T, K)
    diff = (q_prog[:, :T] - q_ref[:, :T]).abs()[:, live]
    scale = q_ref[:, :T][:, live].pow(2).mean().sqrt()
    numbers["q_gap"] = float(diff.max() / scale) if diff.numel() else 0.0

    ref_losses, ref_g, ref_after = follow_updates(w0, taps.batches, spec, device, qnet.F32)
    w0_leaves = [t for _, t in tree_items(w0)]
    if mode == "program":
        prog_losses, prog_g, prog_after = taps.losses, taps.first_moments, taps.params_after
    else:
        precision = qnet.TF32 if mode == "control" else qnet.F32
        prog_losses, prog_g, prog_after = follow_updates(w0, taps.batches, spec, device, precision,
                                                         half_batch=mode == "half_batch")
    numbers["loss_gap"] = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_losses, ref_losses))
    g_ref = [float(g.norm()) for g in ref_g]
    numbers["grad_gap"] = _worst_leaf_gap([float(g.norm()) for g in prog_g], g_ref)
    med_g = statistics.median(g_ref)
    moving = [g >= 1e-3 * med_g for g in g_ref]
    numbers["change_gap"] = _worst_leaf_gap([float((a - w).norm()) for a, w in zip(prog_after, w0_leaves)],
                                            [float((a - w).norm()) for a, w in zip(ref_after, w0_leaves)], moving)
    numbers["target_moved"] = float(sum(int((t != w).sum()) for t, w in zip(taps.target_after, w0_leaves)))
    return numbers


def verdict(numbers: dict, limits: dict):
    """(correct, {name: [number, limit]}): correct when every number is at
    or under its limit; a number without a limit is not correct."""
    checks = {k: [v, limits.get(k)] for k, v in numbers.items()}
    ok = all(lim is not None and math.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks
