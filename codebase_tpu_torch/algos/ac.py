"""On-policy actor-critic family on one device: IA2C, MAA2C, IPPO and MAPPO.

One `train_iteration` collects one padded episode from each of E parallel
envs with the sampling policy, standardises the rewards when the env stack
asks for it, and updates actor and critic on the whole rollout, like the
JAX package's jitted iteration. Here the host drives it eagerly; all
tensors stay on the device and the host reads one counter per iteration.

The semantics are the JAX package's (`codebase_tpu/algos/ac.py`):
- n-step advantage actor-critic loss with entropy bonus and value loss,
  `filled`-masked means; the advantage carries no gradient into the actor;
- bootstrap values from a target critic over all T+1 states, denormalised
  with the return moments as they were before this update;
- an optional centralised critic fed the concatenation of all agents'
  observations: the only difference between IA2C/IPPO and MAA2C/MAPPO;
- PPO: log-probs of the pre-update actor, then `num_epochs` full-batch
  clipped-surrogate epochs, each with an Adam step; metrics are the epochs'
  mean;
- the target critic takes the post-update critic when `env_steps % tau ==
  0`, tested with the count from before this iteration's steps, or a Polyak
  update when tau < 1;
- env steps advance by t_max * E, where t_max is the longest episode in
  the rollout (every env is stepped until the last one finishes), not by
  the number of filled steps;
- with an env that masks actions (SMAClite), masked logits take -1e8 in
  the sampling policy and in the loss's log-probs and entropy, each step
  with the mask of the observation the action was taken from.

`build_train_functions(..., hypers=[...])` trains the U units of a sweep
as one state, as the value-based family does (`algos/dqn.py`): U*E
unit-major envs, the units folded into the networks' agent axis, a leading
unit axis on every per-unit tensor, and each unit's own losses, clip norm,
Adam step, gamma, tau, return moments and env-step count (from its own
longest episode). The centralised critic's input joins the agents of one
unit. One unit is a plain run. Over several ranks (`shard`,
`parallel/mesh.py`) the envs, or a sweep's units, are split.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

import numpy as np

from codebase_tpu_torch.algos.common import (
    Adam,
    early_exit_option,
    hard_update,
    make_optimizer,
    pack_units,
    soft_update,
    unit_hypers,
    unit_scalar,
    unit_values,
)
from codebase_tpu_torch.algos.dqn import refuse_units, unit_agents
from codebase_tpu_torch.envs.api import Environment
from codebase_tpu_torch.envs.vector import Rollout, collect_episodes, resolve_early_exit
from codebase_tpu_torch.envs.wrappers import standardisation_plan
from codebase_tpu_torch.models import distributions as D
from codebase_tpu_torch.models.multi_agent import MultiAgentNetwork
from codebase_tpu_torch.ops.returns import nstep_returns
from codebase_tpu_torch.ops.reward_stream import RewardStream, apply_plan
from codebase_tpu_torch.ops.running_stats import RunningMeanStd
from codebase_tpu_torch.utils import checkpoint as ckpt
from codebase_tpu_torch.utils import debug as debug_checks
from codebase_tpu_torch.utils import profiling
from codebase_tpu_torch.utils.params import load_tree, params_from_numpy, tree_leaves

METRICS = ("loss", "actor_loss", "value_loss", "entropy")


class ACModel(nn.Module):
    """An actor and a critic, each a multi-agent network."""

    def __init__(self, actor: MultiAgentNetwork, critic: MultiAgentNetwork, centralised_critic: bool,
                 ppo: bool, gamma, n_steps: int, entropy_coef: float, value_loss_coef: float,
                 standardise_returns: bool, num_epochs: int, ppo_clip: float, use_action_masks: bool):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.centralised_critic = bool(centralised_critic)
        self.ppo = bool(ppo)
        # a float, or one per unit
        self.gamma = pack_units(unit_values(gamma, actor.n_units, np.float64))
        self.n_steps = int(n_steps)
        self.entropy_coef = float(entropy_coef)
        self.value_loss_coef = float(value_loss_coef)
        self.standardise_returns = bool(standardise_returns)
        self.num_epochs = int(num_epochs)
        self.ppo_clip = float(ppo_clip)
        self.use_action_masks = bool(use_action_masks)

    @staticmethod
    def create(env: Environment, model_cfg, algo_cfg, generator=None, device="cpu", gamma=None) -> "ACModel":
        """`generator` may be a list, one per unit of a sweep, and `gamma`
        then one value per unit (None: the config's)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def network(c, input_sizes, output_sizes):
            return MultiAgentNetwork(
                input_sizes=input_sizes,
                hidden_dims=tuple(c.layers),
                output_sizes=output_sizes,
                parameter_sharing=c.parameter_sharing,
                use_rnn=c.use_rnn,
                use_orthogonal_init=c.use_orthogonal_init,
                fused_rnn=str(c.get("fused_rnn", "auto")),
                compute_dtype=str(c.get("dtype", "float32")),
                generator=generator,
                device=device,
            )

        centralised = bool(model_cfg.critic.centralised)
        critic_inputs = [sum(env.obs_dims)] * env.n_agents if centralised else list(env.obs_dims)
        ppo = model_cfg.get("name", "a2c") == "ppo"
        return ACModel(
            actor=network(model_cfg.actor, env.obs_dims, env.action_dims),
            critic=network(model_cfg.critic, critic_inputs, [1] * env.n_agents),
            centralised_critic=centralised,
            ppo=ppo,
            gamma=float(algo_cfg.gamma) if gamma is None else gamma,
            n_steps=int(algo_cfg.n_steps),
            entropy_coef=float(algo_cfg.entropy_coef),
            value_loss_coef=float(algo_cfg.value_loss_coef),
            standardise_returns=bool(algo_cfg.standardise_returns),
            num_epochs=int(algo_cfg.get("num_epochs", 1)) if ppo else 1,
            ppo_clip=float(algo_cfg.get("ppo_clip", 0.2)),
            use_action_masks=env.has_action_mask,
        )

    @property
    def n_agents(self) -> int:
        return self.actor.n_agents

    @property
    def n_units(self) -> int:
        return self.actor.n_units

    @property
    def _lead(self):
        """The leading unit axis of per-unit tensors: none for one unit."""
        return (self.n_units,) if self.n_units > 1 else ()

    def param_tree(self):
        """{"actor": ..., "critic": ...}, the JAX package's `init_params` tree."""
        return {"actor": self.actor.param_tree(), "critic": self.critic.param_tree()}

    def param_leaves(self):
        """Parameters in the `tree_leaves` order of `param_tree()`: the
        actor's, then the critic's (sorted keys), the JAX order."""
        return tree_leaves(self.param_tree())

    def load_params(self, tree) -> None:
        """Copy the JAX package's whole `init_params` tree, as numpy arrays
        (`{"actor", "critic"}`), into this model."""
        dst = self.param_tree()
        if set(tree) != set(dst):
            raise ValueError(f"param tree has keys {sorted(tree)}; expected {sorted(dst)}")
        device = self.actor.agent_to_group.device
        dtype = self.param_leaves()[0].dtype
        load_tree(dst, {k: params_from_numpy(tree[k], device, dtype) for k in dst})

    def init_rms(self, device="cpu") -> RunningMeanStd:
        """Return moments, one per agent (and unit)."""
        return RunningMeanStd.init((self.n_agents,), device=device, n_units=self.n_units)

    # ---------------------------------------------------------------- acting

    def policy(self):
        """Sampling rollout policy for `collect_episodes`: carry = the
        actor's RNN hiddens (N, L, E, C) or None; obs (E, N, D); mask (E, N,
        A). For U units the envs are unit-major (U*E) and the carry is
        (U*N, L, E, C)."""
        U = self.n_units

        @torch.no_grad()
        def act(carry, obs, mask, generator):
            x = unit_agents(obs, U).unsqueeze(1)  # (U*N, 1, E, D)
            logits, carry = self.actor(x, carry)
            logits = logits[:, 0]  # (U*N, E, A)
            if self.use_action_masks:
                logits = D.apply_mask(logits, unit_agents(mask, U))
            actions = D.sample(generator, logits, env_dim=1, unit_dim=0)  # (U*N, E)
            return carry, unit_agents(actions, U).contiguous()  # (U*E, N)

        return act

    # ------------------------------------------------------------- forwards
    # Per-unit tensors carry a leading unit axis U (none for one unit);
    # network inputs fold the units into the agent axis: (U*N, T, B, D).

    def _critic_inputs(self, obs_agents):
        """obs_agents (N, T, B, D) -> the critic's inputs. Centralised: the
        obs of all agents of the unit concatenated in agent order, fed to
        every agent's critic."""
        if not self.centralised_critic:
            return obs_agents
        U, N = self.n_units, self.n_agents
        x = obs_agents.reshape((U, N) + obs_agents.shape[1:])
        joint = x.permute(0, 2, 3, 1, 4).reshape(x.shape[:1] + x.shape[2:4] + (-1,))  # (U, T, B, N*D)
        return joint.unsqueeze(1).expand((U, N) + joint.shape[1:]).reshape((U * N,) + joint.shape[1:])

    def _per_unit(self, x):
        """(U*N, T, B) per agent -> (U, T, B, N)."""
        return x.reshape((self.n_units, self.n_agents) + x.shape[1:]).permute(0, 2, 3, 1)

    def values(self, critic: MultiAgentNetwork, obs_agents):
        """(N, T, B, D) obs -> (T, B, N) state values of `critic` (this
        model's or a target)."""
        v, _ = critic(self._critic_inputs(obs_agents))
        return self._per_unit(v[..., 0]).reshape(self._lead + v.shape[1:3] + (self.n_agents,))

    def log_probs_entropy(self, obs_agents, actions, amask=None):
        """obs_agents (N, T, B, D), actions (T, B, N), amask (N, T, B, A),
        used when the env masks actions -> (log-probs (T, B, N), entropy
        (T, B) summed over agents)."""
        U, N = self.n_units, self.n_agents
        logits, _ = self.actor(obs_agents)  # (U*N, T, B, A)
        if self.use_action_masks:
            logits = D.apply_mask(logits, amask)
        T, B = logits.shape[1:3]
        acts = actions.reshape(U, T, B, N).permute(0, 3, 1, 2).reshape(U * N, T, B)
        lp = self._per_unit(D.log_prob(logits, acts))  # (U, T, B, N)
        ent = D.entropy(logits).reshape(U, N, T, B).sum(1)
        return lp.reshape(self._lead + (T, B, N)), ent.reshape(self._lead + (T, B))

    # ----------------------------------------------------------------- loss

    def compute_returns(self, target_critic: MultiAgentNetwork, rollout_obs, rewards, dones,
                        ret_rms: RunningMeanStd, shard=None):
        """n-step returns from the target critic's bootstrap values.
        rollout_obs (N, T+1, B, D), rewards (T, B, N), dones (T+1, B).
        Returns ((T, B, N) returns, updated moments).

        With `standardise_returns` the bootstrap values are denormalised
        with the moments as they were, the moments take the returns (every
        (t, b) cell, filled or not), and the returns are normalised with
        the updated moments. With a `shard` that splits the envs, the
        moments take the whole rollout's returns."""
        U, N = self.n_units, self.n_agents
        next_value = self.values(target_critic, rollout_obs)
        T1, B = next_value.shape[-3:-1]
        next_value = next_value.reshape(U, T1, B, N)
        if self.standardise_returns:
            next_value = ret_rms.denormalise(next_value)
        done_n = dones.reshape(U, T1, B, 1).expand(-1, -1, -1, N)
        # time leads in nstep_returns: (T, U, B, N), gamma per unit over (U, B, N)
        returns = nstep_returns(rewards.reshape(U, T1 - 1, B, N).transpose(0, 1), done_n.transpose(0, 1),
                                next_value.transpose(0, 1), self.n_steps,
                                unit_scalar(self.gamma, 3, rewards)).transpose(0, 1)
        if self.standardise_returns:
            ret_rms = ret_rms.update(returns, shard)
            returns = ret_rms.normalise(returns)
        return returns.reshape(self._lead + (T1 - 1, B, N)), ret_rms

    def _loss(self, objective, entropy, advantage, filled, shard=None):
        """The actor's objective (T, B, N), summed over agents, with the
        entropy bonus, plus the value loss summed over agents; means over
        the filled steps. Returns (loss, detached metrics): for U units the
        sum of the units' losses, and (U,) metrics. With a `shard` that
        splits the envs, the means divide by the whole rollout's filled
        count, so the ranks' losses and metrics sum to the whole rollout's."""
        U = self.n_units
        T, B, N = objective.shape[-3:]
        objective, advantage = objective.reshape(U, T, B, N), advantage.reshape(U, T, B, N)
        entropy, filled = entropy.reshape(U, T, B), filled.reshape(U, T, B)
        fsum = filled.sum((1, 2))
        if shard is not None:
            fsum = shard.env_sum(fsum, "loss")
        fsum = fsum.clamp(min=1.0)
        actor_loss = ((-objective.sum(-1) - self.entropy_coef * entropy) * filled).sum((1, 2)) / fsum
        value_loss = ((advantage**2).sum(-1) * filled).sum((1, 2)) / fsum
        loss = actor_loss + self.value_loss_coef * value_loss
        metrics = {
            "loss": loss.detach(),
            "actor_loss": actor_loss.detach(),
            "value_loss": value_loss.detach(),
            "entropy": (entropy.detach() * filled).sum((1, 2)) / fsum,
        }
        return loss.sum(), {k: v.reshape(self._lead) for k, v in metrics.items()}

    def a2c_loss(self, returns, obs_in, actions, filled, amask=None, shard=None):
        """Advantage actor-critic loss. obs_in (N, T, B, D), returns and
        actions (T, B, N), filled (T, B), amask (N, T, B, A). Returns (loss,
        metrics)."""
        values = self.values(self.critic, obs_in)
        log_probs, entropy = self.log_probs_entropy(obs_in, actions, amask)
        advantage = returns - values
        return self._loss(log_probs * advantage.detach(), entropy, advantage, filled, shard)

    def ppo_loss(self, returns, old_log_probs, obs_in, actions, filled, amask=None, shard=None):
        """Clipped-surrogate loss of one epoch against the pre-update
        log-probs (T, B, N). Returns (loss, metrics)."""
        values = self.values(self.critic, obs_in)
        log_probs, entropy = self.log_probs_entropy(obs_in, actions, amask)
        advantage = returns - values
        adv = advantage.detach()
        ratio = torch.exp(log_probs - old_log_probs)
        clipped = torch.clamp(ratio, 1.0 - self.ppo_clip, 1.0 + self.ppo_clip)
        return self._loss(torch.minimum(ratio * adv, clipped * adv), entropy, advantage, filled, shard)


@dataclass
class ACTrainState:
    model: ACModel
    target_critic: MultiAgentNetwork
    opt: Adam
    generator: torch.Generator  # rollouts' action draws and resets
    ret_rms: RunningMeanStd  # return moments (used with standardise_returns)
    # persistent per-env reward moments; None unless the env stack holds a
    # StandardiseReward marker (`ops/reward_stream.py`)
    reward_stream: Optional[RewardStream] = None
    # counters: ints, or (U,) int64 arrays for U units
    env_steps: int = 0
    updates: int = 0
    # (env steps, seconds) of each train iteration, host clock around work
    # that ends in a device sync
    timings: list = field(default_factory=list)
    # this rank's part of a data-parallel run (`parallel/mesh.py`), or None
    shard: Optional[object] = None

    def state_dict(self) -> dict:
        """The checkpoint's state, keyed by the JAX package's `ACTrainState`
        fields: `params` ({"actor", "critic"}) and `target_critic` in flax's
        state-dict form, the optimizer's state in its layout, the moments,
        0-d int32 counters and the generator state in place of the
        threefry `key`. `timings` is not saved. A state of several units (a
        sweep) raises, as `DQNTrainState.state_dict` does."""
        refuse_units(self.model.n_units)
        return {
            "params": ckpt.params_state_dict(self.model.param_tree()),
            "target_critic": ckpt.params_state_dict(self.target_critic.param_tree()),
            "opt_state": self.opt.state_dict(self.model.param_tree()),
            "ret_rms": ckpt.dataclass_state_dict(self.ret_rms),
            # whole on every rank in a data-parallel run (a collective)
            "reward_stream": ckpt.global_envs(ckpt.dataclass_state_dict(self.reward_stream), self.shard),
            "env_steps": ckpt.counter(self.env_steps),
            "updates": ckpt.counter(self.updates),
            **ckpt.generator_state_dict(self.generator),
        }

    def load_state_dict(self, state_dict: dict, path="checkpoint") -> None:
        """Restore a `state_dict()` in place, on this state's device.
        Raises ValueError (and changes nothing) when its generator state
        is missing or of another device type, or its structure differs."""
        ckpt.check_generator(state_dict, self.generator)
        ckpt.check_structure(self.state_dict(), state_dict, path)
        device = self.ret_rms.mean.device
        ckpt.load_params_state_dict(self.model.param_tree(), state_dict["params"])
        ckpt.load_params_state_dict(self.target_critic.param_tree(), state_dict["target_critic"])
        self.opt.load_state_dict(self.model.param_tree(), state_dict["opt_state"])
        self.ret_rms = ckpt.load_dataclass(RunningMeanStd, state_dict["ret_rms"], device)
        self.reward_stream = ckpt.load_dataclass(
            RewardStream, ckpt.local_envs(state_dict["reward_stream"], self.shard, device), device)
        self.env_steps = int(state_dict["env_steps"])
        self.updates = int(state_dict["updates"])
        ckpt.load_generator(self.generator, state_dict)


def build_train_functions(env: Environment, eval_env: Environment, cfg, time_limit: int, device, hypers=None,
                          shard=None, debug=False):
    """Construct (init_state(seed), train_iteration(state), evaluate(state,
    generator), update(state, rollout)). cfg is the `algorithm` config node.
    `debug` runs each train iteration under `utils/debug.checks()` (NaN,
    index and division errors raised with the op and its source line, the
    GRU kernels' outputs scanned), as the JAX package checkifies its chunk.

    `hypers` makes a sweep group of one unit per {"lr"|"gamma"|"tau": value}
    dict, with one seed per unit given to `init_state`, seeded as
    `algos/dqn.py` seeds its units.

    `shard` (`parallel/mesh.py`) makes this one rank of a data-parallel
    run, as in `algos/dqn.py`. Mode env: the rank collects its E/W of the
    E envs and updates on its own rollout; the means divide by the whole
    rollout's filled count, the return moments take the whole rollout's
    returns, the gradients are summed over the ranks before each Adam step,
    and metrics, t_max and the env steps are the whole run's. Mode unit:
    this rank's units of a sweep."""
    acfg = cfg
    lrs, gammas, taus = unit_hypers(acfg, hypers or [{}])
    U = len(lrs)
    n_envs = int(acfg.get("parallel_envs", 1))
    splits = shard is not None and shard.splits_envs
    if splits and U > 1:
        raise ValueError("a sweep group shards its units over the ranks (mode unit), not its envs")
    local_envs = shard.local(n_envs, "parallel_envs") if splits else n_envs
    eval_shard = shard if shard is not None and shard.mode == "unit" else None
    tau = float(acfg.target_update_interval_or_tau)  # the regime; each unit's value is in taus
    reward_plan = standardisation_plan(env)
    early_exit = resolve_early_exit(early_exit_option(acfg), env, n_envs)

    def init_state(seed, generator_seed=None) -> ACTrainState:
        seeds = [int(s) for s in (seed if isinstance(seed, (list, tuple)) else [seed])]
        if len(seeds) != U:
            raise ValueError(f"init_state takes one seed per unit: {U} units, {len(seeds)} seeds")
        init_gens = [torch.Generator().manual_seed(s) for s in seeds]  # weights, made on the host
        model = ACModel.create(env, acfg.model, acfg, generator=init_gens, device=device, gamma=gammas)
        zeros = pack_units(np.zeros(U, np.int64))
        return ACTrainState(
            model=model,
            target_critic=copy.deepcopy(model.critic).requires_grad_(False),
            # one Adam over the whole tree; a clip, if any, covers all of it
            opt=make_optimizer(acfg.optimizer, model.param_leaves(), pack_units(lrs), acfg.grad_clip, n_units=U),
            generator=torch.Generator(device=device).manual_seed(seeds[0] if generator_seed is None
                                                                 else int(generator_seed)),
            ret_rms=model.init_rms(device),
            reward_stream=RewardStream.init(U * local_envs, env.n_agents, device) if reward_plan else None,
            env_steps=zeros,
            updates=zeros,
            shard=shard,
        )

    def update(state: ACTrainState, rollout: Rollout) -> dict:
        """The A2C step or the PPO epochs on one rollout, then the target
        refresh. Leaves `env_steps` to the caller. Returns the metrics."""
        model = state.model
        params = model.param_leaves()
        T1, E = rollout.obs.shape[:2]
        E //= U
        lead = (U,) if U > 1 else ()

        def agents(x):  # (T', U*E, N, ...) -> (U*N, T', E, ...)
            x = x.reshape((x.shape[0], U, E) + x.shape[2:]).permute((1, 3, 0, 2) + tuple(range(4, x.ndim + 1)))
            return x.reshape((-1,) + x.shape[2:]).contiguous()

        def units(x):  # (T', U*E, ...) -> (U, T', E, ...), no unit axis for one unit
            x = x.reshape((x.shape[0], U, E) + x.shape[2:]).transpose(0, 1)
            return x.reshape(lead + x.shape[1:])

        obs_agents = agents(rollout.obs)  # (U*N, T+1, E, D)
        obs_in = obs_agents[:, :-1]
        # the mask of the observation each action was taken from
        amask_in = agents(rollout.action_mask)[:, :-1] if model.use_action_masks else None
        actions, filled = units(rollout.actions), units(rollout.filled)
        with torch.no_grad():
            returns, state.ret_rms = model.compute_returns(
                state.target_critic, obs_agents, units(rollout.rewards), units(rollout.dones), state.ret_rms, shard
            )

        def step(loss):
            grads = torch.autograd.grad(loss, params)
            # the whole rollout's gradient on every rank
            state.opt.step(grads if shard is None else shard.sum_grads(grads))

        if not model.ppo:
            loss, metrics = model.a2c_loss(returns, obs_in, actions, filled, amask_in, shard)
            step(loss)
        else:
            with torch.no_grad():
                old_log_probs, _ = model.log_probs_entropy(obs_in, actions, amask_in)
            epochs = []
            for _ in range(model.num_epochs):
                loss, m = model.ppo_loss(returns, old_log_probs, obs_in, actions, filled, amask_in, shard)
                step(loss)
                epochs.append(m)
            metrics = {k: torch.stack([m[k] for m in epochs]).mean(0) for k in METRICS}
        if shard is not None and shard.splits_envs:
            # the ranks' shares of each metric, summed in one all_reduce
            summed = shard.env_sum(torch.stack([metrics[k] for k in METRICS]), "loss")
            metrics = dict(zip(METRICS, summed))
        # the target critic, with the env-step count from before this
        # iteration's steps (the caller adds them after the update)
        if tau > 1.0:
            hard = unit_values(state.env_steps, U) % taus.astype(np.int64) == 0
            hard_update(state.target_critic.param_leaves(), model.critic.param_leaves(), hard)
        elif tau < 1.0:
            soft_update(state.target_critic.param_leaves(), model.critic.param_leaves(),
                        unit_scalar(taus, 2, params[0]))
        state.updates = pack_units(unit_values(state.updates, U) + 1)
        return metrics

    def train_iteration(state: ACTrainState) -> dict:
        # the spans below are what `codebase_tpu_torch.profile` reads
        with profiling.span("ac/rollout"):
            rollout, _ = collect_episodes(
                env,
                state.model.policy(),
                state.model.actor.init_hiddens(local_envs),
                state.generator,
                U * local_envs,
                time_limit,
                bool(acfg.use_proper_termination),
                early_exit,
                shard,
            )
        if reward_plan is not None:
            with profiling.span("ac/reward_stream"):
                # persistent streaming standardisation of the raw rewards
                state.reward_stream, rewards = apply_plan(
                    reward_plan, state.reward_stream, rollout.stat_rewards, rollout.filled
                )
                rollout = dataclasses.replace(rollout, rewards=rewards)
        with profiling.span("ac/update"):
            metrics = update(state, rollout)
        # step accounting: each unit's longest episode times its envs
        t_max = rollout.episode_lengths.reshape(U, local_envs).amax(1)
        if shard is not None:
            t_max = shard.env_max(t_max)  # the longest episode of any rank
        t_max = t_max.cpu().numpy().astype(np.int64)
        state.env_steps = pack_units(unit_values(state.env_steps, U) + t_max * n_envs)
        return {
            **metrics,
            # this rank's envs (`parallel.mesh.fetch_metrics` gathers them)
            "episode_returns": rollout.episode_returns,  # (U*E, N)
            "episode_lengths": rollout.episode_lengths,  # (U*E,)
        }

    def evaluate(state: ACTrainState, generator: torch.Generator) -> dict:
        """Sampling-policy rollouts on the eval env, `eval_episodes` for
        each unit (unit-major). The training loop logs its own rollouts'
        episodes, as the JAX package does; this is for callers that want
        separate episodes."""
        n = int(acfg.eval_episodes)
        rollout, _ = collect_episodes(
            eval_env, state.model.policy(), state.model.actor.init_hiddens(n), generator, U * n, time_limit,
            early_exit=resolve_early_exit("auto", eval_env, n), shard=eval_shard,
        )
        return {"episode_returns": rollout.episode_returns, "episode_lengths": rollout.episode_lengths}

    if debug:
        train_iteration = debug_checks.checked(train_iteration)
    return init_state, train_iteration, evaluate, update
