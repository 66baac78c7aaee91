"""What decides `correct`, the parts every family shares: the seed's weights
in the program's parameters, the reset tap, the episodes of the sampled envs
against the env's rules (`reference/`), the worst-leaf rule and the
verdict. Each family's taps on its first train iteration, its comparison
with the plain reference (`judge`) and its numbers are in
`families/<family>.py`.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench.reference import lbf as ref_lbf
from portbench.reference import smaclite as ref_smaclite

# the sampled envs, and the sampled rows of each followed batch, unless the
# configuration's reference sets `check_rows`
CHECK_ENVS = 256


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
    """Fill the program's parameters (online and target alike: the target
    tree holds some or all of the online tree's paths) with weights drawn
    on the device from the seed, in one draw; returns the weights as a tree
    of CPU tensors that the reference starts from."""
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


class ResetTap:
    """Wraps the env's `reset_batch` while open: keeps the first rollout's
    reset states, every env's, on the host (SMAClite's state is not in its
    observations)."""

    def __init__(self, env):
        self.env, self.resets = env, None

    def __enter__(self):
        self._reset_batch = self.env.reset_batch
        object.__setattr__(self.env, "reset_batch", self._on_reset)  # the env spec is a frozen dataclass
        return self

    def __exit__(self, *exc):
        object.__delattr__(self.env, "reset_batch")
        self.env = self._reset_batch = None
        return False

    def _on_reset(self, generator, n):
        state, ts = self._reset_batch(generator, n)
        if self.resets is None:
            inner = self.env.inner_state(state)
            self.resets = {k: host(v) for k, v in vars(inner).items() if isinstance(v, torch.Tensor)}
        return state, ts


def worst_leaf_gap(prog, ref, keep=None):
    """max over leaves of |prog - ref| / max(ref, median(ref))."""
    med = statistics.median(ref)
    gaps = [abs(p - r) / max(r, med, 1e-30) for i, (p, r) in enumerate(zip(prog, ref))
            if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def reset_of(resets: dict, e: int) -> dict:
    """Env `e`'s reset state, from the reset tap's host tensors."""
    return {k: v.numpy()[..., e] for k, v in resets.items() if k != "t"}


def episode_numbers(env: dict, episodes: dict, resets=None):
    """(mismatches, reset faults, first mismatch or None) of padded
    episodes against the env's rules. Episode-major numpy arrays: obs (K,
    T+1, N, D), actions, rewards (K, T, N), dones (K, T+1), filled (K, T),
    action_mask (K, T+1, N, A) or None; `resets` the episodes' reset states
    (`reset_of`), which SMAClite needs."""
    x = episodes
    if env["kind"] == "lbf":
        return ref_lbf.check_episodes(env, x["obs"], x["actions"], x["rewards"], x["dones"], x["filled"])
    if env["kind"] == "smaclite":
        return ref_smaclite.check_episodes(env, x["obs"], x["actions"], x["rewards"], x["dones"], x["filled"],
                                           x["action_mask"], resets)
    raise ValueError(f"no reference for env kind {env['kind']!r}")


def step_numbers(env: dict, episodes: dict, device):
    """(mismatches, first mismatch or None) of every transition of every
    env, each from the program's observation before it (`ref_lbf.check_steps`),
    for an env whose state is all in one observation; None for another
    (SMAClite's units' health and cooldowns are not in the observations).
    `episodes` as `episode_numbers` takes them, every env's."""
    if env["kind"] != "lbf":
        return None
    x = episodes
    return ref_lbf.check_steps(env, x["obs"], x["actions"], x["rewards"], x["dones"], x["filled"], device)


def verdict(numbers: dict, limits: dict):
    """(correct, {name: [number, limit]}): correct when every number is at
    or under its limit; a number without a limit is not correct."""
    checks = {k: [v, limits.get(k)] for k, v in numbers.items()}
    ok = all(lim is not None and math.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks


def sampled_envs(seed: int, n_envs: int, check_rows: int):
    """(the generator of the harness's draws, the sorted sampled envs)."""
    rng = np.random.default_rng(int(seed))
    return rng, np.sort(rng.choice(n_envs, size=min(check_rows, n_envs), replace=False))
