"""The value-based family (`algos/dqn.py`: IDQN, VDN, QMIX) in the harness.

The train state: `build_train_functions` of `algos/dqn.py`; an iteration is
one collect and `updates_per_collect` updates of `batch_size` episodes from
the replay. The port's host loop reads the loss back.

What decides `correct`. Set-up drives the train state through its first
iteration with the same call the window makes (`train_iteration(state)`),
with taps that record and change nothing:

- a forward hook on the online critic keeps the Q-values the rollout's
  policy formed (the GRU kernels at T=1, step by step) for a sample of envs
  drawn from the seed;
- the model's `unit_losses` is wrapped for that iteration: it keeps each
  of the first three updates' batch (as the update got it) and loss, the
  optimizer's first moments after the first step (the first gradient as
  Adam got it, clipped: `mu / (1 - b1)`), and the parameters after the third
  step, read at the start of the fourth;
- the env's `reset_batch` is wrapped for that iteration (`check.ResetTap`);
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

After the window (`Train.after_window`), the hard target copy:
`target_schedule` and `target_copy_gap`; 0.

Per-layer arithmetic: `useful_flops` (the networks' products, `counts`),
the GRU call model (`gru_least_seconds`), the ranges `dqn/*`, and the
program's `dqn/iterations` counter as the divisor of its counters.
"""

from __future__ import annotations

import gc
import statistics

import numpy as np
import torch

from portbench import check, counts
from portbench.check import host, to_device, tree_items, worst_leaf_gap
from portbench.reference import qnet
from portbench.reference import smaclite as ref_smaclite

RANGES = {"rollout": "dqn/rollout", "replay_add": "dqn/replay_add", "updates": "dqn/updates"}
LIMITS = ("env_mismatch", "reset_faults", "q_gap", "loss_gap", "grad_gap", "change_gap", "target_moved",
          "target_schedule", "target_copy_gap")
TRAFFIC = ("parallel_envs", "batch_size", "updates_per_collect", "buffer_size")
FOLLOWED_UPDATES = 3


def useful_flops(model: dict, time_limit: int, batch_size: int, updates_per_collect: int):
    """(flops per collected env step, flops per train iteration's updates):
    the matrix products of the networks that the layers of `RNNSpec` build.
    The rollout counts one forward per collected env step; each update
    counts the online forward, the target forward and the backward (twice a
    forward) over (T+1)*B rows; QMIX adds its mixer and hypernetworks over
    T*B rows, four forwards' worth (online forward, backward, target
    forward).

    `model`: obs_dims, action_dims (one per agent), layers, use_rnn, and for
    QMIX `mixer` {n_agents, state_dim, embed_dim, hypernet_layers,
    hypernet_embed}."""
    per_step = sum(counts.network_macs_per_row(d, model["layers"], a, model["use_rnn"])
                   for d, a in zip(model["obs_dims"], model["action_dims"]))
    rollout = 2.0 * per_step
    T, B, U = int(time_limit), int(batch_size), int(updates_per_collect)
    update = U * B * (T + 1) * per_step * 2.0 * 4.0  # online fwd, target fwd, backward (2x)
    if model.get("mixer"):
        update += U * B * T * counts.mixer_macs_per_row(**model["mixer"]) * 2.0 * 4.0
    return rollout, update


def gru_least_seconds(calls: dict, s: dict, peaks: dict) -> float:
    """The least time of the GRU calls of one iteration: one forward at T=1
    over the E envs for each rollout step run (the forward launches beyond
    the updates' two each), and per update the online and target forwards
    over (T+1, B) and one backward. `calls`: launches an iteration by
    kernel; `s`: the shapes T, E, B, U, G, H."""
    rollout_steps = calls["gru_fwd_kernel"] - 2 * s["U"]
    fwd_roll, _ = counts.gru_bounds("fwd", s["G"], 1, s["E"], s["H"], peaks)
    fwd_upd, _ = counts.gru_bounds("fwd", s["G"], s["T"] + 1, s["B"], s["H"], peaks)
    bwd_upd, _ = counts.gru_bounds("bwd", s["G"], s["T"] + 1, s["B"], s["H"], peaks)
    return rollout_steps * fwd_roll + s["U"] * (2 * fwd_upd + bwd_upd)


class Train:
    """The DQN family's train state for one cell."""

    def __init__(self, cfg, env, eval_env, device, traffic: dict, seed: int):
        from codebase_tpu_torch.algos.dqn import build_train_functions

        self.cfg, self.env, self.device = cfg, env, device
        self.T = int(cfg.env.time_limit)
        self.n_envs = int(cfg.algorithm.parallel_envs)
        self.traffic = traffic
        self.updates_per_iter = int(traffic["updates_per_collect"])
        init_state, self.train_iteration, _ = build_train_functions(env, eval_env, cfg.algorithm, self.T, device)
        self.state = init_state(seed)

    @staticmethod
    def read_back(metrics: dict) -> None:
        float(metrics["loss"])  # the host loop reads the loss back, which waits for the updates

    def env_steps(self) -> int:
        return int(self.state.env_steps)

    def make_weights(self, seed: int):
        return check.make_weights(self.state.model.param_tree(), self.state.target.param_tree(), seed, self.device)

    def taps(self, seed: int, reference: dict):
        return Taps(self.state, self.env, self.n_envs, seed, int(reference.get("check_rows", check.CHECK_ENVS)))

    def model(self) -> dict:
        """What the useful-flops count needs, from the configuration."""
        acfg = self.cfg.algorithm
        model = {"obs_dims": list(self.env.obs_dims), "action_dims": list(self.env.action_dims),
                 "layers": list(acfg.model.layers), "use_rnn": bool(acfg.model.use_rnn)}
        if acfg.model.name == "qmix":
            mx = acfg.model.mixing
            model["mixer"] = {"n_agents": self.env.n_agents, "state_dim": sum(self.env.obs_dims),
                              "embed_dim": int(mx.embed_dim), "hypernet_layers": int(mx.hypernet_layers),
                              "hypernet_embed": int(mx.hypernet_embed)}
        return model

    def useful_flops(self):
        return useful_flops(self.model(), self.T, self.traffic["batch_size"], self.traffic["updates_per_collect"])

    def shapes(self) -> dict:
        model = self.model()
        return {"T": self.T, "E": self.n_envs, "B": int(self.traffic["batch_size"]),
                "U": int(self.traffic["updates_per_collect"]), "G": len(model["obs_dims"]),
                "H": int(model["layers"][0])}

    def gru_least_seconds(self, calls: dict, peaks: dict) -> float:
        return gru_least_seconds(calls, self.shapes(), peaks)

    @staticmethod
    def iterations(harness_iterations: int):
        """The program's own `dqn/iterations` counter, since the process
        started (None from a program without the counter registry)."""
        from codebase_tpu_torch.utils import profiling

        return profiling.counters().get("dqn/iterations") if hasattr(profiling, "counters") else None

    def after_window(self, cell) -> dict:
        """After the window, whether the hard target copies come when due
        and copy the online parameters. `target_schedule`: the program's
        update count off the iterations run, plus its last copy off the last
        multiple of the interval (both 0). Then the program's counter is set
        so that a copy falls due at the last update of one more iteration,
        and `target_copy_gap` is the largest gap between the target and the
        online parameters after it (a copy: 0)."""
        interval = int(self.cfg.algorithm.target_update_interval_or_tau)
        state, per_iter = self.state, self.updates_per_iter
        n, last = int(state.updates), int(state.last_target_update)
        schedule = abs(n - per_iter * cell.iters) + abs(last - interval * (n // interval))
        state.last_target_update = n + per_iter - interval
        cell.iterate()
        gap = max(float((t - p).detach().abs().max())
                  for t, p in zip(state.target.param_leaves(), state.model.param_leaves()))
        return {"target_schedule": float(schedule), "target_copy_gap": gap}

    def free(self) -> None:
        del self.state, self.train_iteration
        gc.collect()


class Taps:
    """Records the first train iteration (see the module's docstring)."""

    def __init__(self, state, env, n_envs: int, seed: int, check_rows: int = check.CHECK_ENVS):
        self.state, self.env = state, env
        self.check_rows = check_rows
        self.rng, self.envs = check.sampled_envs(seed, n_envs, check_rows)
        self.n_envs = n_envs
        self.q = []  # the rollout's Q-values of the sampled envs, one (N, K, A) a step
        self.batches, self.losses = [], []
        self.first_moments = None
        self.params_after = None
        self.calls = 0
        self.env_first_mismatch = None

    def __enter__(self):
        state = self.state
        self._idx = torch.as_tensor(self.envs, device=state.buffer.obs.device)
        self._hook = state.model.critic.register_forward_hook(self._on_critic)
        self._unit_losses = state.model.unit_losses
        state.model.unit_losses = self._on_unit_losses
        self._resets = check.ResetTap(self.env).__enter__()
        return self

    def __exit__(self, *exc):
        self._hook.remove()
        del self.state.model.unit_losses
        self._resets.__exit__(*exc)
        return False

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
        self.resets = self._resets.resets
        self.q = host(torch.stack(self.q)) if self.q else None  # (T, N, K, A)
        self.losses = [float(x.sum()) for x in self.losses]
        rows = self.check_rows
        self.batch_rows = [np.sort(self.rng.choice(b["filled"].shape[-1], size=min(rows, b["filled"].shape[-1]),
                                                   replace=False)) for b in self.batches]
        self.target_after = [host(p) for p in self.state.target.param_leaves()]
        # the program's state is the program's: nothing here keeps it alive
        self.state = self.env = self._idx = self._hook = self._unit_losses = self._resets = None
        if len(self.batches) < FOLLOWED_UPDATES or self.params_after is None:
            raise RuntimeError(f"the first iteration made {self.calls} updates; the check follows "
                               f"{FOLLOWED_UPDATES} and reads the parameters at the start of the next")


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
    rows = [_batch_rows(b, pick) for b, pick in zip(taps.batches, taps.batch_rows)]
    if env["kind"] == "lbf":
        results = [check.episode_numbers(env, x) for x in [r] + rows]
    elif env["kind"] == "smaclite":
        resets = taps.resets
        results = [check.episode_numbers(env, r, [check.reset_of(resets, e) for e in taps.envs])]
        # a batch row's episode: the env whose reset put its allies where
        # the row's first observation sees them (own row and col / map size)
        ally_r, ally_c = resets["ally_r"].numpy(), resets["ally_c"].numpy()
        key_of_env = {tuple(np.concatenate([ally_r[:, e], ally_c[:, e]])): e for e in range(ally_r.shape[-1])}
        for x in rows:
            keys = [tuple(np.concatenate([np.rint(o[:, 2] * env["rows"]), np.rint(o[:, 3] * env["cols"])]).astype(int))
                    for o in x["obs"][:, 0]]
            found = [key_of_env.get(k) for k in keys]
            missing = sum(e is None for e in found)
            keep = [i for i, e in enumerate(found) if e is not None]
            res = ref_smaclite.check_episodes(env, *(x[k][keep] for k in ("obs", "actions", "rewards", "dones", "filled",
                                                                          "action_mask")),
                                              [check.reset_of(resets, found[i]) for i in keep])
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
    numbers["grad_gap"] = worst_leaf_gap([float(g.norm()) for g in prog_g], g_ref)
    med_g = statistics.median(g_ref)
    moving = [g >= 1e-3 * med_g for g in g_ref]
    numbers["change_gap"] = worst_leaf_gap([float((a - w).norm()) for a, w in zip(prog_after, w0_leaves)],
                                           [float((a - w).norm()) for a, w in zip(ref_after, w0_leaves)], moving)
    numbers["target_moved"] = float(sum(int((t != w).sum()) for t, w in zip(taps.target_after, w0_leaves)))
    return numbers
