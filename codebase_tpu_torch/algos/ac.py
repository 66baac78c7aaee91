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
Sweeps' traced hyperparameters and the mesh wait for later slices
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from codebase_tpu_torch.algos.common import Adam, early_exit_option, hard_update, make_optimizer, soft_update
from codebase_tpu_torch.envs.api import Environment
from codebase_tpu_torch.envs.vector import Rollout, collect_episodes
from codebase_tpu_torch.envs.wrappers import standardisation_plan
from codebase_tpu_torch.models import distributions as D
from codebase_tpu_torch.models.multi_agent import MultiAgentNetwork
from codebase_tpu_torch.ops.returns import nstep_returns
from codebase_tpu_torch.ops.reward_stream import RewardStream, apply_plan
from codebase_tpu_torch.ops.running_stats import RunningMeanStd
from codebase_tpu_torch.utils.params import load_tree, params_from_numpy, tree_leaves

METRICS = ("loss", "actor_loss", "value_loss", "entropy")


class ACModel(nn.Module):
    """An actor and a critic, each a multi-agent network."""

    def __init__(self, actor: MultiAgentNetwork, critic: MultiAgentNetwork, centralised_critic: bool,
                 ppo: bool, gamma: float, n_steps: int, entropy_coef: float, value_loss_coef: float,
                 standardise_returns: bool, num_epochs: int, ppo_clip: float, use_action_masks: bool):
        super().__init__()
        self.actor = actor
        self.critic = critic
        self.centralised_critic = bool(centralised_critic)
        self.ppo = bool(ppo)
        self.gamma = float(gamma)
        self.n_steps = int(n_steps)
        self.entropy_coef = float(entropy_coef)
        self.value_loss_coef = float(value_loss_coef)
        self.standardise_returns = bool(standardise_returns)
        self.num_epochs = int(num_epochs)
        self.ppo_clip = float(ppo_clip)
        self.use_action_masks = bool(use_action_masks)

    @staticmethod
    def create(env: Environment, model_cfg, algo_cfg, generator=None, device="cpu") -> "ACModel":
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
            gamma=float(algo_cfg.gamma),
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
        """Return moments, one per agent."""
        return RunningMeanStd.init((self.n_agents,), device=device)

    # ---------------------------------------------------------------- acting

    def policy(self):
        """Sampling rollout policy for `collect_episodes`: carry = the
        actor's RNN hiddens (N, L, E, C) or None; obs (E, N, D); mask (E, N,
        A)."""

        @torch.no_grad()
        def act(carry, obs, mask, generator):
            x = obs.transpose(0, 1).unsqueeze(1)  # (N, 1, E, D)
            logits, carry = self.actor(x, carry)
            logits = logits[:, 0]  # (N, E, A)
            if self.use_action_masks:
                logits = D.apply_mask(logits, mask.transpose(0, 1))
            actions = D.sample(generator, logits)  # (N, E)
            return carry, actions.T.contiguous()  # (E, N)

        return act

    # ------------------------------------------------------------- forwards

    def _critic_inputs(self, obs_agents):
        """obs_agents (N, T, B, D) -> the critic's inputs. Centralised: all
        agents' obs concatenated in agent order, fed to every agent's
        critic."""
        if not self.centralised_critic:
            return obs_agents
        joint = torch.cat(list(obs_agents), dim=-1)
        return joint.unsqueeze(0).expand((obs_agents.shape[0],) + joint.shape)

    def values(self, critic: MultiAgentNetwork, obs_agents):
        """(N, T, B, D) obs -> (T, B, N) state values of `critic` (this
        model's or a target)."""
        v, _ = critic(self._critic_inputs(obs_agents))
        return v[..., 0].permute(1, 2, 0)

    def log_probs_entropy(self, obs_agents, actions, amask=None):
        """obs_agents (N, T, B, D), actions (T, B, N), amask (N, T, B, A),
        used when the env masks actions -> (log-probs (T, B, N), entropy
        (T, B) summed over agents)."""
        logits, _ = self.actor(obs_agents)  # (N, T, B, A)
        if self.use_action_masks:
            logits = D.apply_mask(logits, amask)
        lp = D.log_prob(logits, actions.permute(2, 0, 1))  # (N, T, B)
        return lp.permute(1, 2, 0), D.entropy(logits).sum(0)

    # ----------------------------------------------------------------- loss

    def compute_returns(self, target_critic: MultiAgentNetwork, rollout_obs, rewards, dones,
                        ret_rms: RunningMeanStd):
        """n-step returns from the target critic's bootstrap values.
        rollout_obs (N, T+1, B, D), rewards (T, B, N), dones (T+1, B).
        Returns ((T, B, N) returns, updated moments).

        With `standardise_returns` the bootstrap values are denormalised
        with the moments as they were, the moments take the returns (every
        (t, b) cell, filled or not), and the returns are normalised with
        the updated moments."""
        next_value = self.values(target_critic, rollout_obs)  # (T+1, B, N)
        if self.standardise_returns:
            next_value = ret_rms.denormalise(next_value)
        done_n = dones.unsqueeze(-1).expand(-1, -1, self.n_agents)
        returns = nstep_returns(rewards, done_n, next_value, self.n_steps, self.gamma)
        if self.standardise_returns:
            ret_rms = ret_rms.update(returns)
            returns = ret_rms.normalise(returns)
        return returns, ret_rms

    def _loss(self, objective, entropy, advantage, filled):
        """The actor's objective (T, B, N), summed over agents, with the
        entropy bonus, plus the value loss summed over agents; means over
        the filled steps. Returns (loss, detached metrics)."""
        fsum = filled.sum().clamp(min=1.0)
        actor_loss = ((-objective.sum(-1) - self.entropy_coef * entropy) * filled).sum() / fsum
        value_loss = ((advantage**2).sum(-1) * filled).sum() / fsum
        loss = actor_loss + self.value_loss_coef * value_loss
        metrics = {
            "loss": loss.detach(),
            "actor_loss": actor_loss.detach(),
            "value_loss": value_loss.detach(),
            "entropy": (entropy.detach() * filled).sum() / fsum,
        }
        return loss, metrics

    def a2c_loss(self, returns, obs_in, actions, filled, amask=None):
        """Advantage actor-critic loss. obs_in (N, T, B, D), returns and
        actions (T, B, N), filled (T, B), amask (N, T, B, A). Returns (loss,
        metrics)."""
        values = self.values(self.critic, obs_in)
        log_probs, entropy = self.log_probs_entropy(obs_in, actions, amask)
        advantage = returns - values
        return self._loss(log_probs * advantage.detach(), entropy, advantage, filled)

    def ppo_loss(self, returns, old_log_probs, obs_in, actions, filled, amask=None):
        """Clipped-surrogate loss of one epoch against the pre-update
        log-probs (T, B, N). Returns (loss, metrics)."""
        values = self.values(self.critic, obs_in)
        log_probs, entropy = self.log_probs_entropy(obs_in, actions, amask)
        advantage = returns - values
        adv = advantage.detach()
        ratio = torch.exp(log_probs - old_log_probs)
        clipped = torch.clamp(ratio, 1.0 - self.ppo_clip, 1.0 + self.ppo_clip)
        return self._loss(torch.minimum(ratio * adv, clipped * adv), entropy, advantage, filled)


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
    env_steps: int = 0
    updates: int = 0
    # (env steps, seconds) of each train iteration, host clock around work
    # that ends in a device sync
    timings: list = field(default_factory=list)


def build_train_functions(env: Environment, eval_env: Environment, cfg, time_limit: int, device):
    """Construct (init_state(seed), train_iteration(state), evaluate(state,
    generator), update(state, rollout)). cfg is the `algorithm` config node."""
    acfg = cfg
    n_envs = int(acfg.get("parallel_envs", 1))
    tau = float(acfg.target_update_interval_or_tau)
    reward_plan = standardisation_plan(env)
    early_exit = early_exit_option(acfg)

    def init_state(seed: int) -> ACTrainState:
        init_gen = torch.Generator().manual_seed(int(seed))  # weights, made on the host
        model = ACModel.create(env, acfg.model, acfg, generator=init_gen, device=device)
        return ACTrainState(
            model=model,
            target_critic=copy.deepcopy(model.critic).requires_grad_(False),
            # one Adam over the whole tree; a clip, if any, covers all of it
            opt=make_optimizer(acfg.optimizer, model.param_leaves(), float(acfg.lr), acfg.grad_clip),
            generator=torch.Generator(device=device).manual_seed(int(seed)),
            ret_rms=model.init_rms(device),
            reward_stream=RewardStream.init(n_envs, env.n_agents, device) if reward_plan else None,
        )

    def update(state: ACTrainState, rollout: Rollout) -> dict:
        """The A2C step or the PPO epochs on one rollout, then the target
        refresh. Leaves `env_steps` to the caller. Returns the metrics."""
        model = state.model
        params = model.param_leaves()
        obs_agents = rollout.obs.permute(2, 0, 1, 3).contiguous()  # (N, T+1, E, D)
        obs_in = obs_agents[:, :-1]
        # the mask of the observation each action was taken from
        amask_in = rollout.action_mask.permute(2, 0, 1, 3)[:, :-1] if model.use_action_masks else None
        with torch.no_grad():
            returns, state.ret_rms = model.compute_returns(
                state.target_critic, obs_agents, rollout.rewards, rollout.dones, state.ret_rms
            )
        if not model.ppo:
            loss, metrics = model.a2c_loss(returns, obs_in, rollout.actions, rollout.filled, amask_in)
            state.opt.step(torch.autograd.grad(loss, params))
        else:
            with torch.no_grad():
                old_log_probs, _ = model.log_probs_entropy(obs_in, rollout.actions, amask_in)
            epochs = []
            for _ in range(model.num_epochs):
                loss, m = model.ppo_loss(returns, old_log_probs, obs_in, rollout.actions, rollout.filled, amask_in)
                state.opt.step(torch.autograd.grad(loss, params))
                epochs.append(m)
            metrics = {k: torch.stack([m[k] for m in epochs]).mean() for k in METRICS}
        # the target critic, with the env-step count from before this
        # iteration's steps (the caller adds them after the update)
        if tau > 1.0:
            if state.env_steps % int(tau) == 0:
                hard_update(state.target_critic.param_leaves(), model.critic.param_leaves())
        elif tau < 1.0:
            soft_update(state.target_critic.param_leaves(), model.critic.param_leaves(), tau)
        state.updates += 1
        return metrics

    def train_iteration(state: ACTrainState) -> dict:
        # the named ranges below are what `codebase_tpu_torch.profile` reads
        with record_function("ac/rollout"):
            rollout, _ = collect_episodes(
                env,
                state.model.policy(),
                state.model.actor.init_hiddens(n_envs),
                state.generator,
                n_envs,
                time_limit,
                bool(acfg.use_proper_termination),
                early_exit,
            )
        if reward_plan is not None:
            with record_function("ac/reward_stream"):
                # persistent streaming standardisation of the raw rewards
                state.reward_stream, rewards = apply_plan(
                    reward_plan, state.reward_stream, rollout.stat_rewards, rollout.filled
                )
                rollout = dataclasses.replace(rollout, rewards=rewards)
        with record_function("ac/update"):
            metrics = update(state, rollout)
        # step accounting: the longest episode times the envs
        state.env_steps += int(rollout.episode_lengths.max().item()) * n_envs
        return {
            **metrics,
            "episode_returns": rollout.episode_returns,  # (E, N)
            "episode_lengths": rollout.episode_lengths,  # (E,)
        }

    def evaluate(state: ACTrainState, generator: torch.Generator) -> dict:
        """Sampling-policy rollouts on the eval env. The training loop logs
        its own rollouts' episodes, as the JAX package does; this is for
        callers that want separate episodes."""
        n = int(acfg.eval_episodes)
        rollout, _ = collect_episodes(
            eval_env, state.model.policy(), state.model.actor.init_hiddens(n), generator, n, time_limit
        )
        return {"episode_returns": rollout.episode_returns, "episode_lengths": rollout.episode_lengths}

    return init_state, train_iteration, evaluate, update
