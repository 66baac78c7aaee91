"""The actor-critic family (`algos/ac.py`: IA2C, MAA2C, IPPO, MAPPO) in the
harness.

The train state: `build_train_functions` of `algos/ac.py`; an iteration is
one on-policy rollout of the E envs (every env stepped to the longest
episode) and the update on all of it: the target critic's n-step returns,
then one A2C step or, for PPO, the pre-update log-probs and `num_epochs`
full-batch clipped-surrogate epochs, each an Adam step, then the target
critic's refresh. The port's host loop reads the four loss metrics back.

What decides `correct`. Set-up drives the train state through its first
iteration with the same call the window makes, with taps that record and
change nothing:

- a forward hook on the actor keeps the logits the rollout's policy formed
  (the networks at T=1, step by step) for a sample of envs drawn from the
  seed;
- the model's `compute_returns` is wrapped for that iteration: it keeps
  what the rollout handed the update (every env's observations, rewards
  and dones) and the program's returns of the sampled envs;
- its `ppo_loss` and `a2c_loss`: the actions, filled steps and action masks
  the update got, each epoch's loss, and Adam's first moments after the
  first step (`mu / (1 - b1)`: the first gradient, unclipped);
- the env's `reset_batch` (`check.ResetTap`);
- after the iteration: the parameters, the target critic and the env steps
  the iteration added.

Once the window has closed, the reference (`reference/ac.py`, and the env's
rules under `reference/`) takes the update from the seed's weights on what
the rollout handed the update, in blocks of envs, and the numbers below are
compared with their limits (the configuration file's):

- `env_mismatch`, `reset_faults`: the sampled envs' episodes against the
  env's rules, as the DQN family's; 0.
- `all_env_mismatch`: every env's transitions, each from the program's
  observation before it, and every first observation, against the env's
  rules in bulk (`check.step_numbers`), where the env's state is all in its
  observations (LBF): the update takes every env's rollout, so a fault in
  envs outside the sample would feed the program and the reference alike; 0.
- `logit_gap`: the widest gap between the rollout's logits and the
  reference's, over the filled steps, in units of the reference's RMS.
- `sample_gap`: the largest gap, in standard errors, between how often an
  agent's action was drawn over every env's filled steps and the sum of
  its probabilities under the reference (a sampler that takes the argmax,
  or draws from other probabilities, fails it).
- `return_gap`: the widest gap of the sampled envs' n-step returns, filled
  steps, over the reference's RMS.
- `loss_gap`: the widest gap of the epochs' losses, each over the larger of
  the reference's loss and its scale, the mean magnitude of a filled row's
  loss (the actor's and the value's terms cancel, so that a loss can pass
  near 0 where its rounding does not).
- `grad_gap`, `change_gap`: as the DQN family's, over the actor's and the
  critic's leaves, the change over all the epochs.
- `step_count`: the env steps the first iteration added, off t_max * E (the
  longest episode of the rollout times the envs); 0.

After the window (`Train.after_window`): `target_schedule`, the target
critic's elements that an iteration moved whose pre-iteration env-step
count was not a multiple of the interval; and `target_copy_gap`, the
largest gap between the target and the critic after an iteration whose
count was one, and after the first iteration (count 0); 0.

Per-layer arithmetic: `useful_flops`, the GRU call model
(`gru_least_seconds`), the ranges `ac/*`, and the harness's own count of the
train iterations since the process started as the divisor of the
program's counters (the family counts none).
"""

from __future__ import annotations

import gc
import inspect
import statistics

import torch

from portbench import check, counts
from portbench.check import host, to_device, tree_items, worst_leaf_gap
from portbench.reference import ac as ref_ac

RANGES = {"rollout": "ac/rollout", "updates": "ac/update"}
LIMITS = ("env_mismatch", "reset_faults", "all_env_mismatch", "logit_gap", "sample_gap", "return_gap", "loss_gap",
          "grad_gap", "change_gap", "step_count", "target_schedule", "target_copy_gap")
TRAFFIC = ("parallel_envs",)


def network_model(acfg, env) -> dict:
    """What the arithmetic needs of the actor and the critic, from the
    configuration: each network's inputs and outputs an agent, layers,
    use_rnn and groups (1 when the agents share it), and the update's kind."""
    m = acfg.model
    obs = [int(d) for d in env.obs_dims]
    n = len(obs)

    def net(c, inputs, outputs):
        return {"inputs": inputs, "outputs": outputs, "layers": [int(h) for h in c.layers],
                "use_rnn": bool(c.use_rnn), "groups": 1 if c.parameter_sharing is True else n}

    ppo = m.get("name", "a2c") == "ppo"
    return {"actor": net(m.actor, obs, [int(a) for a in env.action_dims]),
            "critic": net(m.critic, [sum(obs)] * n if m.critic.centralised else obs, [1] * n),
            "ppo": ppo, "epochs": int(acfg.get("num_epochs", 1)) if ppo else 1}


def _macs(net: dict) -> int:
    return sum(counts.network_macs_per_row(d, net["layers"], a, net["use_rnn"])
               for d, a in zip(net["inputs"], net["outputs"]))


def useful_flops(model: dict, time_limit: int, n_envs: int):
    """(flops per collected env step, flops per train iteration's update).
    The rollout counts one actor forward per env step; the update, over the
    T*E steps of the rollout, the target critic's forward over the (T+1)*E
    states, for PPO the pre-update actor forward, and each epoch's actor and
    critic forward and backward (twice a forward)."""
    actor, critic = _macs(model["actor"]), _macs(model["critic"])
    T, E = int(time_limit), int(n_envs)
    update = (T + 1) * critic + (T * actor if model["ppo"] else 0) + model["epochs"] * 3 * T * (actor + critic)
    return 2.0 * actor, 2.0 * E * update


def gru_calls(model: dict):
    """(the update's GRU forward launches, its backward launches) an
    iteration: the target critic's forward, for PPO the pre-update actor
    forward, and each epoch's forward and backward of each recurrent
    network."""
    a, c = model["actor"]["use_rnn"], model["critic"]["use_rnn"]
    epochs = model["epochs"]
    return c * (1 + epochs) + a * (int(model["ppo"]) + epochs), (a + c) * epochs


def gru_least_seconds(calls: dict, model: dict, T: int, E: int, peaks: dict) -> float:
    """The least time of the GRU calls of one iteration (`counts.gru_bounds`
    each): the actor's forward at T=1 over the E envs for each rollout step
    run (the forward launches beyond the update's, `gru_calls`), and the
    update's calls over (T, E), the target critic's over (T+1, E)."""
    actor, critic = model["actor"], model["critic"]
    forwards, _ = gru_calls(model)

    def bound(net, direction, steps):
        return counts.gru_bounds(direction, net["groups"], steps, E, net["layers"][0], peaks)[0]

    least = 0.0
    if actor["use_rnn"]:
        least += (calls["gru_fwd_kernel"] - forwards) * bound(actor, "fwd", 1)
        least += int(model["ppo"]) * bound(actor, "fwd", T)
        least += model["epochs"] * (bound(actor, "fwd", T) + bound(actor, "bwd", T))
    if critic["use_rnn"]:
        least += bound(critic, "fwd", T + 1) + model["epochs"] * (bound(critic, "fwd", T) + bound(critic, "bwd", T))
    return least


class Train:
    """The actor-critic family's train state for one cell."""

    def __init__(self, cfg, env, eval_env, device, traffic: dict, seed: int):
        from codebase_tpu_torch.algos.ac import METRICS, build_train_functions

        self.cfg, self.env, self.device = cfg, env, device
        self.T = int(cfg.env.time_limit)
        self.n_envs = int(cfg.algorithm.parallel_envs)
        self.interval = float(cfg.algorithm.target_update_interval_or_tau)
        if self.interval <= 1.0:
            raise ValueError("the check follows hard target copies (target_update_interval_or_tau > 1)")
        self.metrics = METRICS
        init_state, self.train_iteration, _, _ = build_train_functions(env, eval_env, cfg.algorithm, self.T, device)
        self.state = init_state(seed)

    def read_back(self, metrics: dict) -> None:
        for k in self.metrics:  # the host loop's reads; the first waits for the update
            float(metrics[k])

    def env_steps(self) -> int:
        return int(self.state.env_steps)

    def make_weights(self, seed: int):
        state = self.state
        return check.make_weights(state.model.param_tree(), {"critic": state.target_critic.param_tree()}, seed,
                                  self.device)

    def taps(self, seed: int, reference: dict):
        return Taps(self.state, self.env, self.n_envs, seed, int(reference.get("check_rows", check.CHECK_ENVS)),
                    int(self.interval))

    def model(self) -> dict:
        return network_model(self.cfg.algorithm, self.env)

    def useful_flops(self):
        return useful_flops(self.model(), self.T, self.n_envs)

    def gru_least_seconds(self, calls: dict, peaks: dict) -> float:
        return gru_least_seconds(calls, self.model(), self.T, self.n_envs, peaks)

    @staticmethod
    def iterations(harness_iterations: int):
        return harness_iterations

    def after_window(self, cell) -> dict:
        """Two more iterations: one from an env-step count one past a
        multiple of the interval, which must leave the target critic as it
        was, and one from a multiple, after which it must equal the
        critic."""
        state, interval = self.state, int(self.interval)
        target, critic = state.target_critic.param_leaves(), state.model.critic.param_leaves()
        state.env_steps = interval * (int(state.env_steps) // interval + 1) + 1
        before = [t.detach().clone() for t in target]
        cell.iterate()
        moved = sum(int((t != b).sum()) for t, b in zip(target, before))
        state.env_steps = interval * (int(state.env_steps) // interval + 1)
        cell.iterate()
        gap = max(float((t - p).detach().abs().max()) for t, p in zip(target, critic))
        return {"target_schedule": float(moved), "target_copy_gap": max(gap, cell.taps.first_copy_gap)}

    def free(self) -> None:
        del self.state, self.train_iteration
        gc.collect()


class Taps:
    """Records the first train iteration (see the module's docstring)."""

    def __init__(self, state, env, n_envs: int, seed: int, check_rows: int, interval: int):
        self.state, self.env, self.n_envs, self.interval = state, env, n_envs, interval
        self.rng, self.envs = check.sampled_envs(seed, n_envs, check_rows)
        self.logits = []  # the rollout's logits of the sampled envs, one (N, K, A) a step
        self.rollout = None  # what the rollout handed the update, on the host
        self.losses = []
        self.first_moments = None
        self.env_steps_before = int(state.env_steps)
        self.env_first_mismatch = None

    def __enter__(self):
        model = self.state.model
        self._idx = torch.as_tensor(self.envs, device=model.param_leaves()[0].device)
        self._hook = model.actor.register_forward_hook(self._on_actor)
        self._compute_returns = model.compute_returns
        model.compute_returns = self._on_compute_returns
        for name in ("a2c_loss", "ppo_loss"):
            setattr(model, name, self._loss_tap(getattr(model, name)))
        self._resets = check.ResetTap(self.env).__enter__()
        return self

    def __exit__(self, *exc):
        self._hook.remove()
        for name in ("compute_returns", "a2c_loss", "ppo_loss"):
            delattr(self.state.model, name)
        self._resets.__exit__(*exc)
        return False

    def _on_actor(self, module, args, output):
        x = args[0]  # (N, T, E, D)
        if self.rollout is None and x.shape[1] == 1 and x.shape[2] == self.n_envs:
            self.logits.append(output[0][:, 0].index_select(1, self._idx).detach().clone())

    @torch.no_grad()
    def _on_compute_returns(self, target_critic, rollout_obs, rewards, dones, ret_rms, shard=None):
        returns, rms = self._compute_returns(target_critic, rollout_obs, rewards, dones, ret_rms, shard)
        if self.rollout is None:
            self.rollout = {"obs": host(rollout_obs), "rewards": host(rewards), "dones": host(dones)}
            self.returns = host(returns.index_select(1, self._idx))  # (T, K, N)
        return returns, rms

    def _loss_tap(self, loss_fn):
        signature = inspect.signature(loss_fn)

        def tapped(*args, **kwargs):
            opt = self.state.opt
            if len(self.losses) == 1:
                self.first_moments = [host(m) / (1.0 - opt.b1) for m in opt.mu]
            if not self.losses:
                got = signature.bind(*args, **kwargs).arguments
                mask = got.get("amask")
                if mask is not None:
                    mask = whole_masks(mask)
                self.rollout.update(actions=host(got["actions"]), filled=host(got["filled"]),
                                    action_mask=None if mask is None else host(mask))
            loss, metrics = loss_fn(*args, **kwargs)
            self.losses.append(loss.detach().clone())
            return loss, metrics

        return tapped

    def finish(self):
        """After the iteration: the parameters, the target critic and the
        env steps added, everything on the host."""
        state = self.state
        if self.first_moments is None:  # one step: Adam's moments after it
            self.first_moments = [host(m) / (1.0 - state.opt.b1) for m in state.opt.mu]
        self.params_after = [host(p) for p in state.model.param_leaves()]
        self.target_after = [host(p) for p in state.target_critic.param_leaves()]
        critic_after = [host(p) for p in state.model.critic.param_leaves()]
        due = self.env_steps_before % self.interval == 0
        self.first_copy_gap = max(float((t - c).abs().max()) for t, c in zip(self.target_after, critic_after)) \
            if due else 0.0
        self.env_steps_added = int(state.env_steps) - self.env_steps_before
        self.logits = host(torch.stack(self.logits)) if self.logits else None  # (T, N, K, A)
        self.losses = [float(x) for x in self.losses]
        self.resets = self._resets.resets
        # the program's state is the program's: nothing here keeps it alive
        self.state = self.env = self._idx = self._hook = self._compute_returns = self._resets = None
        if self.rollout is None or not self.losses or self.logits is None:
            raise RuntimeError("the first iteration made no rollout or no update that the check can follow")


def whole_masks(amask):
    """The rollout's masks of all T+1 observations, (N, T+1, E, A), of which
    the update gets the first T as a view."""
    base = amask._base
    if base is None or base.shape[:1] + base.shape[2:] != amask.shape[:1] + amask.shape[2:] or \
            base.shape[1] != amask.shape[1] + 1:
        raise RuntimeError(f"the update's action masks {tuple(amask.shape)} are no view of the rollout's")
    return base


def episodes(rollout: dict, envs=None) -> dict:
    """The sampled envs' episodes (every env's where `envs` is None),
    episode-major numpy arrays, from what the rollout handed the update."""
    idx = None if envs is None else torch.as_tensor(envs)

    def take(t, dim):
        return t if idx is None else t.index_select(dim, idx)

    mask = rollout.get("action_mask")
    return {
        "obs": take(rollout["obs"], 2).permute(2, 1, 0, 3).numpy(),
        "actions": take(rollout["actions"], 1).permute(1, 0, 2).numpy(),
        "rewards": take(rollout["rewards"], 1).permute(1, 0, 2).numpy(),
        "dones": take(rollout["dones"], 1).T.numpy(),
        "filled": take(rollout["filled"], 1).T.numpy(),
        "action_mask": None if mask is None else take(mask, 2).permute(2, 1, 0, 3).numpy(),
    }


def _gap(prog, ref, live):
    """The widest |prog - ref| over the live cells, over the reference's RMS
    there: prog and ref (T, K, ...), live (T, K)."""
    diff = (prog - ref).abs()[live]
    return float(diff.max() / ref[live].pow(2).mean().sqrt()) if diff.numel() else 0.0


def judge(taps: Taps, w0, spec: dict, device, mode: str = "program"):
    """The numbers compared, for the program (`mode` "program") or for the
    reference put in its place: "control" (TF32 products) or the planted
    fault "half_batch" (the update over half the envs). Returns {name:
    number}."""
    numbers = {}
    ro = taps.rollout
    env = spec["env"]
    eps = episodes(ro, taps.envs)
    resets = [check.reset_of(taps.resets, e) for e in taps.envs] if env["kind"] == "smaclite" else None
    bad, faults, taps.env_first_mismatch = check.episode_numbers(env, eps, resets)
    numbers["env_mismatch"], numbers["reset_faults"] = float(bad), float(faults)
    whole = check.step_numbers(env, episodes(ro), device)
    if whole is not None:
        numbers["all_env_mismatch"] = float(whole[0])
        taps.env_first_mismatch = taps.env_first_mismatch or whole[1]

    idx = torch.as_tensor(taps.envs)
    live = ro["filled"].index_select(1, idx).bool()  # (T, K)
    with torch.no_grad():
        obs = ro["obs"][:, :-1].index_select(2, idx).to(device)  # (N, T, K, D)
        actor = to_device(w0["actor"], device)
        logits_ref = ref_ac.network(actor, obs, ref_ac.F32).cpu()  # (N, T, K, A)
        if mode == "control":
            logits_prog = ref_ac.network(actor, obs, ref_ac.TF32).cpu()
        else:
            logits_prog = taps.logits.permute(1, 0, 2, 3)
    steps = min(logits_prog.shape[1], logits_ref.shape[1])  # an early exit runs fewer steps
    numbers["logit_gap"] = _gap(logits_prog[:, :steps].permute(1, 2, 0, 3), logits_ref[:, :steps].permute(1, 2, 0, 3),
                                live[:steps])

    ref = ref_ac.follow(w0, ro, spec, device, ref_ac.F32)
    numbers["sample_gap"] = ref_ac.sample_gap(ref["samples"])
    if mode == "program":
        prog = {"returns": taps.returns, "losses": taps.losses, "first_grad": taps.first_moments,
                "after": taps.params_after}
    else:
        precision = ref_ac.TF32 if mode == "control" else ref_ac.F32
        prog = ref_ac.follow(w0, ro, spec, device, precision, half_batch=mode == "half_batch")
        prog["returns"] = taps.returns if mode == "half_batch" else prog["returns"].index_select(1, idx)
    numbers["return_gap"] = _gap(prog["returns"], ref["returns"].index_select(1, idx), live)
    numbers["loss_gap"] = max(abs(p - r) / max(abs(r), a, 1e-30)
                              for p, r, a in zip(prog["losses"], ref["losses"], ref["scales"]))
    g_ref = [float(g.norm()) for g in ref["first_grad"]]
    numbers["grad_gap"] = worst_leaf_gap([float(g.norm()) for g in prog["first_grad"]], g_ref)
    w0_leaves = [t for _, t in tree_items(w0)]
    med_g = statistics.median(g_ref)
    moving = [g >= 1e-3 * med_g for g in g_ref]
    numbers["change_gap"] = worst_leaf_gap([float((a - w).norm()) for a, w in zip(prog["after"], w0_leaves)],
                                           [float((a - w).norm()) for a, w in zip(ref["after"], w0_leaves)], moving)
    t_max = int(ro["filled"].sum(0).max())
    numbers["step_count"] = float(abs(taps.env_steps_added - t_max * ro["filled"].shape[1]))
    return numbers
