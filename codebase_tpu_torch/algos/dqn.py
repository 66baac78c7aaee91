"""Off-policy value-based family on one device: IDQN, VDN and QMIX.

One `train_iteration` performs an epsilon-greedy rollout of E parallel
episodes, the reward standardisation when the env stack asks for it, the
replay insert, U double-Q updates on one pre-gathered batch and target
maintenance, like the JAX package's jitted iteration. Here the host drives
it eagerly; all tensors stay on the device and the host reads one counter
per iteration.

Loss semantics match the JAX package: IDQN's per-agent double-Q TD loss
over whole episodes, summed across agents; VDN's and QMIX's team TD loss on
agent 0's (cooperative) reward, with the agents' chosen values summed (VDN)
or mixed by the QMIX hypernetwork over the concatenated observations; a
`filled`-masked mean; optional return standardisation; joint epsilon
exploration (one coin per env flips all agents to random actions); hard
target copy every `target_update_interval_or_tau` updates when that is > 1,
else a Polyak update. With an env that masks actions (SMAClite), the greedy
action and the exploring draw take valid actions only, and the target
side of the loss sees masked actions at -1e8 (the target Q, and under
double Q the online Q before its argmax).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn
from torch.profiler import record_function

from codebase_tpu_torch.algos.common import early_exit_option, hard_update, make_optimizer, soft_update
from codebase_tpu_torch.envs.api import Environment
from codebase_tpu_torch.envs.vector import collect_episodes
from codebase_tpu_torch.envs.wrappers import standardisation_plan
from codebase_tpu_torch.models import distributions as D
from codebase_tpu_torch.models.mixers import QMixer
from codebase_tpu_torch.models.multi_agent import MultiAgentNetwork
from codebase_tpu_torch.ops.replay import (
    ReplayState,
    batch_to_reference_layout,
    replay_add,
    replay_init,
    replay_sample_many,
)
from codebase_tpu_torch.ops.reward_stream import RewardStream, apply_plan
from codebase_tpu_torch.ops.running_stats import RunningMeanStd
from codebase_tpu_torch.ops.schedules import epsilon_schedule
from codebase_tpu_torch.utils.params import load_tree, params_from_numpy, tree_leaves, tree_map

MIXER_TYPES = {"qnetwork": "none", "vdn": "vdn", "qmix": "qmix"}


class DQNModel(nn.Module):
    """The value-based model: a multi-agent critic and, for QMIX, a mixer."""

    def __init__(self, critic: MultiAgentNetwork, mixer: Optional[QMixer], mixer_type: str,
                 gamma: float, double_q: bool, standardise_returns: bool, use_action_masks: bool):
        super().__init__()
        self.critic = critic
        self.mixer = mixer
        self.mixer_type = mixer_type
        self.gamma = float(gamma)
        self.double_q = bool(double_q)
        self.standardise_returns = bool(standardise_returns)
        self.use_action_masks = bool(use_action_masks)

    @staticmethod
    def create(env: Environment, model_cfg, algo_cfg, generator=None, device="cpu") -> "DQNModel":
        name = model_cfg.get("name", "qnetwork")
        if name not in MIXER_TYPES:
            raise ValueError(f"model.name must be one of {sorted(MIXER_TYPES)}; got {name!r}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        critic = MultiAgentNetwork(
            input_sizes=env.obs_dims,
            hidden_dims=tuple(model_cfg.layers),
            output_sizes=env.action_dims,
            parameter_sharing=model_cfg.parameter_sharing,
            use_rnn=model_cfg.use_rnn,
            use_orthogonal_init=model_cfg.use_orthogonal_init,
            fused_rnn=str(model_cfg.get("fused_rnn", "auto")),
            compute_dtype=str(model_cfg.get("dtype", "float32")),
            generator=generator,
            device=device,
        )
        mixer = None
        if MIXER_TYPES[name] == "qmix":
            mixing = model_cfg.mixing
            # the state is the concatenation of all agents' observations
            mixer = QMixer(
                n_agents=env.n_agents,
                state_dim=sum(env.obs_dims),
                embed_dim=int(mixing.embed_dim),
                hypernet_layers=int(mixing.hypernet_layers),
                hypernet_embed=int(mixing.hypernet_embed),
                generator=generator,
                device=device,
            )
        return DQNModel(critic, mixer, MIXER_TYPES[name], float(algo_cfg.gamma), bool(algo_cfg.double_q),
                        bool(algo_cfg.get("standardise_returns", False)), env.has_action_mask)

    def param_tree(self):
        """{"critic": ..., "mixer": ...} (the mixer only for QMIX), the JAX
        package's `init_params` tree."""
        tree = {"critic": self.critic.param_tree()}
        if self.mixer is not None:
            tree["mixer"] = self.mixer.param_tree()
        return tree

    def param_leaves(self):
        """Parameters in the fixed `tree_leaves` order of `param_tree()`
        (sorted keys: the critic's, then the mixer's), the JAX order."""
        return tree_leaves(self.param_tree())

    def clip_mask(self):
        """One bool per `param_leaves()` entry: True for the critic's. Only
        the critic is clipped when there is a mixer; None clips all."""
        if self.mixer is None:
            return None
        tree = self.param_tree()
        return tree_leaves({k: tree_map(lambda _, k=k: k == "critic", v) for k, v in tree.items()})

    def load_params(self, tree) -> None:
        """Copy the JAX package's whole `init_params` tree, as numpy arrays
        (`{"critic", "mixer"}`), into this model."""
        dst = self.param_tree()
        if set(tree) != set(dst):
            raise ValueError(f"param tree has keys {sorted(tree)}; expected {sorted(dst)}")
        device = self.critic.agent_to_group.device
        load_tree(dst, {k: params_from_numpy(tree[k], device) for k in dst})

    def init_rms(self, device="cpu") -> RunningMeanStd:
        """Return moments: per agent for IDQN, one for the team otherwise."""
        shape = (self.critic.n_agents,) if self.mixer_type == "none" else (1,)
        return RunningMeanStd.init(shape, device=device)

    # ---------------------------------------------------------------- acting

    def policy(self, epsilon: float):
        """Epsilon-greedy rollout policy for `collect_episodes`.

        carry = RNN hiddens (N, L, E, C) or None; obs (E, N, D); mask (E, N,
        A). Joint exploration: one coin per env flips every agent to a
        uniform random action, uniform over the valid ones when the env masks
        actions."""

        @torch.no_grad()
        def act(carry, obs, mask, generator):
            x = obs.transpose(0, 1).unsqueeze(1)  # (N, 1, E, D)
            q, carry = self.critic(x, carry)
            q = q[:, 0]  # (N, E, A)
            if self.use_action_masks:
                amask = mask.transpose(0, 1)  # (N, E, A)
                q = D.apply_mask(q, amask)
            greedy = q.argmax(-1)  # (N, E)
            E = obs.shape[0]
            explore = torch.rand((E,), generator=generator, device=obs.device) < epsilon
            if self.use_action_masks:
                rand = D.sample(generator, torch.where(amask > 0, 0.0, float("-inf")))
            else:
                rand = torch.randint(0, q.shape[-1], greedy.shape, generator=generator, device=obs.device)
            actions = torch.where(explore[None, :], rand, greedy)
            return carry, actions.T.contiguous()  # (E, N)

        return act

    # ------------------------------------------------------------------ loss

    def loss(self, target: "DQNModel", batch: dict, ret_rms: RunningMeanStd):
        """Episode double-Q TD loss on a reference-layout batch:
        obss (N, T+1, B, D), actions (N, T, B), rewards (N, T, B),
        dones (T+1, B), filled (T, B), action_mask (N, T+1, B, A) or None.
        Returns (loss, new ret_rms).

        With `standardise_returns` the target is denormalised with the
        moments as they were, the moments are updated with the returns
        (every (t, b) cell, filled or not, as the JAX package does), and the
        returns are normalised with the updated moments."""
        obss = batch["obss"]
        actions = batch["actions"]
        q_all, _ = self.critic(obss)  # (N, T+1, B, A)
        chosen = q_all[:, :-1].gather(-1, actions.unsqueeze(-1)).squeeze(-1)  # (N, T, B)
        filled = batch["filled"]
        with torch.no_grad():
            tq_all, _ = target.critic(obss)
            tq = tq_all[:, 1:]
            if self.use_action_masks:
                valid = batch["action_mask"][:, 1:] > 0
                tq = torch.where(valid, tq, D.MASK_NEG)
            if self.double_q:
                qc = q_all.detach()[:, 1:]
                if self.use_action_masks:
                    qc = torch.where(valid, qc, D.MASK_NEG)
                a_prime = qc.argmax(-1, keepdim=True)
                target_qs = tq.gather(-1, a_prime).squeeze(-1)
            else:
                target_qs = tq.amax(-1)  # (N, T, B)

        if self.mixer_type == "none":
            with torch.no_grad():
                dones = batch["dones"][1:][None]  # (1, T, B)
                if self.standardise_returns:
                    # moments over the trailing agent axis
                    target_qs = ret_rms.denormalise(target_qs.permute(1, 2, 0)).permute(2, 0, 1)
                returns = batch["rewards"] + self.gamma * target_qs * (1.0 - dones)
                if self.standardise_returns:
                    ret_rms = ret_rms.update(returns.permute(1, 2, 0))
                    returns = ret_rms.normalise(returns.permute(1, 2, 0)).permute(2, 0, 1)
            loss_tb = ((chosen - returns) ** 2).sum(0)  # sum over agents
        else:
            # cooperative: the team reward of agent 0
            rewards = batch["rewards"][0]  # (T, B)
            dones = batch["dones"][1:]  # (T, B)
            if self.mixer_type == "vdn":
                chosen_tot = chosen.sum(0)  # (T, B)
                target_tot = target_qs.sum(0)
            else:
                # states: the agents' obs concatenated -> (T+1, B, N*D)
                states = torch.cat(list(obss), dim=-1)
                chosen_tot = self.mixer(chosen, states[:-1])
                with torch.no_grad():
                    target_tot = target.mixer(target_qs, states[1:])
            with torch.no_grad():
                if self.standardise_returns:
                    target_tot = target_tot * torch.sqrt(ret_rms.var[0]) + ret_rms.mean[0]
                returns = rewards + self.gamma * target_tot * (1.0 - dones)
                if self.standardise_returns:
                    ret_rms = ret_rms.update(returns.reshape(-1, 1))
                    returns = (returns - ret_rms.mean[0]) / torch.sqrt(ret_rms.var[0])
            loss_tb = (chosen_tot - returns) ** 2
        loss = (loss_tb * filled).sum() / filled.sum().clamp(min=1.0)
        return loss, ret_rms


@dataclass
class DQNTrainState:
    model: DQNModel
    target: DQNModel
    opt: object
    buffer: ReplayState
    generator: torch.Generator  # rollouts, exploration and replay sampling
    ret_rms: RunningMeanStd  # return moments (used with standardise_returns)
    # persistent per-env reward moments; None unless the env stack holds a
    # StandardiseReward marker (`ops/reward_stream.py`)
    reward_stream: Optional[RewardStream] = None
    env_steps: int = 0
    updates: int = 0
    last_target_update: int = 0
    # (env steps, seconds) of each train iteration, host clock around work
    # that ends in a device sync
    timings: list = field(default_factory=list)


def build_train_functions(env: Environment, eval_env: Environment, cfg, time_limit: int, device):
    """Construct (init_state(seed), train_iteration(state), evaluate(state,
    generator)). cfg is the `algorithm` config node."""
    acfg = cfg
    n_envs = int(acfg.get("parallel_envs", 1))
    batch_size = int(acfg.batch_size)
    # round the episode capacity up to a multiple of the insert width, as
    # the JAX package does
    buffer_size = -(-int(acfg.buffer_size) // n_envs) * n_envs
    updates_per_collect = acfg.get("updates_per_collect", "auto")
    n_updates = n_envs if updates_per_collect == "auto" else int(updates_per_collect)
    tau = float(acfg.target_update_interval_or_tau)
    slot_reuse = str(acfg.get("replay_slot_reuse", "reference"))
    eps_sched = epsilon_schedule(
        acfg.eps_decay_style,
        float(acfg.eps_decay_over),
        float(acfg.eps_start),
        float(acfg.eps_end),
        float(acfg.eps_exp_decay_rate),
        int(acfg.total_steps),
    )
    obs_dtype = getattr(
        torch, str(acfg.get("replay_obs_dtype", "bfloat16" if env.integer_valued_obs else "float32"))
    )
    reward_plan = standardisation_plan(env)
    early_exit = early_exit_option(acfg)

    def init_state(seed: int) -> DQNTrainState:
        init_gen = torch.Generator().manual_seed(int(seed))  # weights, made on the host
        model = DQNModel.create(env, acfg.model, acfg, generator=init_gen, device=device)
        target = copy.deepcopy(model).requires_grad_(False)
        return DQNTrainState(
            model=model,
            target=target,
            opt=make_optimizer(acfg.optimizer, model.param_leaves(), float(acfg.lr), acfg.grad_clip,
                               clip_mask=model.clip_mask()),
            buffer=replay_init(
                buffer_size, time_limit, env.n_agents, env.obs_dim, env.n_actions,
                with_mask=env.has_action_mask, obs_dtype=obs_dtype, device=device,
            ),
            generator=torch.Generator(device=device).manual_seed(int(seed)),
            ret_rms=model.init_rms(device),
            reward_stream=RewardStream.init(n_envs, env.n_agents, device) if reward_plan else None,
        )

    def update(state: DQNTrainState, batch: dict):
        """One gradient update, then target maintenance."""
        model = state.model
        params = model.param_leaves()
        loss, state.ret_rms = model.loss(state.target, batch, state.ret_rms)
        grads = torch.autograd.grad(loss, params)
        state.opt.step(grads)
        state.updates += 1
        if tau > 1.0:
            if state.updates - state.last_target_update >= tau:
                hard_update(state.target.param_leaves(), params)
                state.last_target_update = state.updates
        elif tau < 1.0:
            soft_update(state.target.param_leaves(), params, tau)
        return loss.detach()

    def train_iteration(state: DQNTrainState) -> dict:
        # the named ranges below are what `codebase_tpu_torch.profile` reads
        epsilon = eps_sched(state.env_steps)
        with record_function("dqn/rollout"):
            rollout, _ = collect_episodes(
                env,
                state.model.policy(epsilon),
                state.model.critic.init_hiddens(n_envs),
                state.generator,
                n_envs,
                time_limit,
                bool(acfg.use_proper_termination),
                early_exit,
            )
        if reward_plan is not None:
            with record_function("dqn/reward_stream"):
                # persistent streaming standardisation of the raw rewards
                state.reward_stream, rewards = apply_plan(
                    reward_plan, state.reward_stream, rollout.stat_rewards, rollout.filled
                )
                rollout = dataclasses.replace(rollout, rewards=rewards)
        with record_function("dqn/replay_add"):
            replay_add(state.buffer, rollout, slot_reuse)
            state.env_steps += int(rollout.env_steps.item())

        if state.env_steps > int(acfg.training_start) and state.buffer.can_sample(batch_size):
            with record_function("dqn/updates"):
                # ONE gather for all updates of this iteration
                batches = replay_sample_many(state.buffer, state.generator, batch_size, n_updates)
                losses = [
                    update(state, batch_to_reference_layout(
                        {k: (v[u] if v is not None else None) for k, v in batches.items()}
                    ))
                    for u in range(n_updates)
                ]
                loss = torch.stack(losses).mean()
        else:
            loss = torch.tensor(math.nan)  # "no update happened" for the logger's nanmean
        return {
            "loss": loss,
            "epsilon": epsilon,
            "episode_returns": rollout.episode_returns,  # (E, N)
            "episode_lengths": rollout.episode_lengths,  # (E,)
        }

    def evaluate(state: DQNTrainState, generator: torch.Generator) -> dict:
        """Rollouts on the eval env at `eps_evaluation`."""
        n = int(acfg.eval_episodes)
        rollout, _ = collect_episodes(
            eval_env,
            state.model.policy(float(acfg.eps_evaluation)),
            state.model.critic.init_hiddens(n),
            generator,
            n,
            time_limit,
        )
        return {"episode_returns": rollout.episode_returns, "episode_lengths": rollout.episode_lengths}

    return init_state, train_iteration, evaluate
