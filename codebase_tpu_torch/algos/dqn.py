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

`build_train_functions(..., hypers=[...])` trains the U units of a sweep
(one {"lr"|"gamma"|"tau": value} dict each, seeds given to `init_state`)
as one state: the U*E envs are unit-major, the networks fold the units into
their agent axis (`models/multi_agent.py`), and every per-unit tensor
(counters, moments, losses, dones and filled of a batch) carries a leading
unit axis. Each unit keeps its own loss (a filled-masked mean), clip norm,
Adam step, epsilon, counters, target maintenance, return moments and
replay slots, as `jax.vmap` over the JAX package's iteration gives them,
so one unit's numbers never depend on another's; they share the group's
generator and every kernel launch. One unit is a plain run: scalar
counters and hyperparameters, no unit axis.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

import numpy as np

from codebase_tpu_torch.algos.common import (
    early_exit_option,
    hard_update,
    make_optimizer,
    pack_units,
    soft_update,
    unit_hypers,
    unit_scalar,
    unit_values,
)
from codebase_tpu_torch.envs.api import Environment
from codebase_tpu_torch.envs.vector import collect_episodes, resolve_early_exit
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
from codebase_tpu_torch.parallel import mesh
from codebase_tpu_torch.utils import checkpoint as ckpt
from codebase_tpu_torch.utils import debug as debug_checks
from codebase_tpu_torch.utils import profiling
from codebase_tpu_torch.utils.params import load_tree, params_from_numpy, tree_leaves, tree_map

MIXER_TYPES = {"qnetwork": "none", "vdn": "vdn", "qmix": "qmix"}


class DQNModel(nn.Module):
    """The value-based model: a multi-agent critic and, for QMIX, a mixer."""

    def __init__(self, critic: MultiAgentNetwork, mixer: Optional[QMixer], mixer_type: str,
                 gamma, double_q: bool, standardise_returns: bool, use_action_masks: bool):
        super().__init__()
        self.critic = critic
        self.mixer = mixer
        self.mixer_type = mixer_type
        # a float, or one per unit
        self.gamma = pack_units(unit_values(gamma, critic.n_units, np.float64))
        self.double_q = bool(double_q)
        self.standardise_returns = bool(standardise_returns)
        self.use_action_masks = bool(use_action_masks)

    @staticmethod
    def create(env: Environment, model_cfg, algo_cfg, generator=None, device="cpu", gamma=None) -> "DQNModel":
        """`generator` may be a list, one per unit of a sweep, and `gamma`
        then one value per unit (None: the config's)."""
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
        gamma = float(algo_cfg.gamma) if gamma is None else gamma
        return DQNModel(critic, mixer, MIXER_TYPES[name], gamma, bool(algo_cfg.double_q),
                        bool(algo_cfg.get("standardise_returns", False)), env.has_action_mask)

    @property
    def n_units(self) -> int:
        return self.critic.n_units

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
        """Return moments: per agent for IDQN, one for the team otherwise
        (each unit its own)."""
        shape = (self.critic.n_agents,) if self.mixer_type == "none" else (1,)
        return RunningMeanStd.init(shape, device=device, n_units=self.n_units)

    # ---------------------------------------------------------------- acting

    def policy(self, epsilon):
        """Epsilon-greedy rollout policy for `collect_episodes`.

        carry = RNN hiddens (N, L, E, C) or None; obs (E, N, D); mask (E, N,
        A). Joint exploration: one coin per env flips every agent to a
        uniform random action, uniform over the valid ones when the env masks
        actions. For U units the envs are unit-major (U*E of them), the
        carry is (U*N, L, E, C) and `epsilon` may be one value per unit."""
        U = self.n_units

        @torch.no_grad()
        def act(carry, obs, mask, generator):
            E = obs.shape[0] // U
            x = unit_agents(obs, U).unsqueeze(1)  # (U*N, 1, E, D)
            q, carry = self.critic(x, carry)
            q = q[:, 0]  # (U*N, E, A)
            if self.use_action_masks:
                amask = unit_agents(mask, U)  # (U*N, E, A)
                q = D.apply_mask(q, amask)
            greedy = q.argmax(-1)  # (U*N, E)
            eps = unit_scalar(epsilon, 3, obs)
            # each draw at the global shape, this rank's envs (or units) kept
            explore = mesh.draw(lambda s: torch.rand(s, generator=generator, device=obs.device),
                                (U * E,), 0).reshape(U, 1, E) < eps
            if self.use_action_masks:
                rand = D.sample(generator, torch.where(amask > 0, 0.0, float("-inf")), env_dim=1, unit_dim=0)
            else:
                rand = mesh.draw(lambda s: torch.randint(0, q.shape[-1], s, generator=generator, device=obs.device),
                                 greedy.shape, 1, 0)
            actions = torch.where(explore, rand.reshape(U, -1, E), greedy.reshape(U, -1, E))
            return carry, actions.transpose(1, 2).reshape(U * E, -1).contiguous()  # (U*E, N)

        return act

    # ------------------------------------------------------------------ loss

    def loss(self, target: "DQNModel", batch: dict, ret_rms: RunningMeanStd, shard=None):
        """Episode double-Q TD loss on a reference-layout batch:
        obss (N, T+1, B, D), actions (N, T, B), rewards (N, T, B),
        dones (T+1, B), filled (T, B), action_mask (N, T+1, B, A) or None.
        Returns (loss, new ret_rms); for U units the sum of the units'
        losses (see `unit_losses`)."""
        losses, ret_rms = self.unit_losses(target, batch, ret_rms, shard)
        return losses.sum(), ret_rms

    def unit_losses(self, target: "DQNModel", batch: dict, ret_rms: RunningMeanStd, shard=None):
        """`loss` per unit: (U,) losses and the new moments. For U units the
        agents of the batch are U*N (unit-major) and dones and filled carry
        a leading unit axis, as `batch_to_reference_layout` lays them out.

        With `standardise_returns` the target is denormalised with the
        moments as they were, the moments are updated with the returns
        (every (t, b) cell, filled or not, as the JAX package does), and the
        returns are normalised with the updated moments.

        With a `shard` that splits the envs over W ranks, every rank holds
        the whole batch and takes the loss of its B/W rows: the mean's
        denominator counts the whole batch's filled cells and the return
        moments take the whole batch's returns, so the ranks' losses sum to
        the whole batch's loss (and their gradients to its gradient)."""
        U, N = self.n_units, self.critic.n_agents
        fsum = batch["filled"].reshape((U,) + batch["actions"].shape[-2:]).sum((1, 2)).clamp(min=1.0)
        if shard is not None:
            # this rank's rows: B is axis 2 of the per-agent leaves, the last of dones and filled
            batch = {k: v if v is None else shard.part(v, v.ndim - 1 if k in ("dones", "filled") else 2)
                     for k, v in batch.items()}
        obss = batch["obss"]
        actions = batch["actions"]
        T, B = actions.shape[-2:]
        q_all, _ = self.critic(obss)  # (U*N, T+1, B, A)
        chosen = q_all[:, :-1].gather(-1, actions.unsqueeze(-1)).squeeze(-1).reshape(U, N, T, B)
        filled = batch["filled"].reshape(U, T, B)
        dones = batch["dones"].reshape(U, T + 1, B)[:, 1:]  # (U, T, B)
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
                target_qs = tq.amax(-1)
            target_qs = target_qs.reshape(U, N, T, B)

        if self.mixer_type == "none":
            gamma = unit_scalar(self.gamma, 4, obss)
            with torch.no_grad():
                if self.standardise_returns:
                    # moments over the trailing agent axis
                    target_qs = ret_rms.denormalise(target_qs.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                returns = batch["rewards"].reshape(U, N, T, B) + gamma * target_qs * (1.0 - dones[:, None])
                if self.standardise_returns:
                    ret_rms = ret_rms.update(returns.permute(0, 2, 3, 1), shard)
                    returns = ret_rms.normalise(returns.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            loss_tb = ((chosen - returns) ** 2).sum(1)  # sum over agents
        else:
            gamma = unit_scalar(self.gamma, 3, obss)
            # cooperative: the team reward of agent 0
            rewards = batch["rewards"].reshape(U, N, T, B)[:, 0]  # (U, T, B)
            if self.mixer_type == "vdn":
                chosen_tot = chosen.sum(1)  # (U, T, B)
                target_tot = target_qs.sum(1)
            else:
                # states: each unit's agents' obs concatenated -> (U, T+1, B, N*D)
                states = obss.reshape((U, N) + obss.shape[1:]).permute(0, 2, 3, 1, 4).reshape(U, T + 1, B, -1)
                lead = (U,) if U > 1 else ()
                mixer_call = ("qmix/mixer", (U, T * B, states.shape[-1]))
                with profiling.span("qmix/mixer"):
                    profiling.count(mixer_call)
                    chosen_tot = self.mixer(chosen.reshape(U * N, T, B), states[:, :-1].reshape(lead + (T, B, -1)))
                chosen_tot = chosen_tot.reshape(U, T, B)
                with torch.no_grad(), profiling.span("qmix/mixer"):
                    profiling.count(mixer_call)
                    target_tot = target.mixer(target_qs.reshape(U * N, T, B),
                                              states[:, 1:].reshape(lead + (T, B, -1))).reshape(U, T, B)
            with torch.no_grad():
                if self.standardise_returns:
                    target_tot = ret_rms.denormalise(target_tot[..., None])[..., 0]
                returns = rewards + gamma * target_tot * (1.0 - dones)
                if self.standardise_returns:
                    ret_rms = ret_rms.update(returns, shard)
                    returns = ret_rms.normalise(returns[..., None])[..., 0]
            loss_tb = (chosen_tot - returns) ** 2
        losses = (loss_tb * filled).sum((1, 2)) / fsum
        return losses, ret_rms


def unit_agents(x, n_units: int):
    """(U*E, N, ...) unit-major envs -> (U*N, E, ...) unit-major agents."""
    x = x.reshape((n_units, -1) + x.shape[1:]).transpose(1, 2)
    return x.reshape((-1,) + x.shape[2:])


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
    # counters: ints, or (U,) int64 arrays for U units
    env_steps: int = 0
    updates: int = 0
    last_target_update: int = 0
    # (env steps, seconds) of each train iteration, host clock around work
    # that ends in a device sync
    timings: list = field(default_factory=list)
    # this rank's part of a data-parallel run (`parallel/mesh.py`), or None
    shard: Optional[object] = None

    def state_dict(self) -> dict:
        """The checkpoint's state, keyed by the JAX package's
        `DQNTrainState` fields: `params` and `target_params` in flax's
        state-dict form, the optimizer's state in its layout, every replay
        field with `pos`, the moments, 0-d int32 counters and the generator
        state in place of the threefry `key`. Tensors stay where they are
        (the codec moves each to the host as it writes it); `timings` is
        not saved. A state of several units (a sweep) raises: a sweep does
        not checkpoint, as the JAX package's vmapped sweep does not.

        Over W ranks the replay slots and the reward streams are assembled
        in the one-rank run's global layout on every rank (a collective),
        so a checkpoint moves between world sizes."""
        refuse_units(self.model.n_units)
        buf = self.buffer

        def slots(t):
            return None if t is None else ckpt.global_slots(t, self.shard, buf.n_envs)

        return {
            "params": ckpt.params_state_dict(self.model.param_tree()),
            "target_params": ckpt.params_state_dict(self.target.param_tree()),
            "opt_state": self.opt.state_dict(self.model.param_tree()),
            "buffer": {
                "obs": slots(buf.obs), "actions": slots(buf.actions.to(torch.int32)), "rewards": slots(buf.rewards),
                "dones": slots(buf.dones), "filled": slots(buf.filled), "action_mask": slots(buf.action_mask),
                "pos": ckpt.counter(buf.pos),
            },
            "ret_rms": ckpt.dataclass_state_dict(self.ret_rms),
            "reward_stream": ckpt.global_envs(ckpt.dataclass_state_dict(self.reward_stream), self.shard),
            "env_steps": ckpt.counter(self.env_steps),
            "updates": ckpt.counter(self.updates),
            "last_target_update": ckpt.counter(self.last_target_update),
            **ckpt.generator_state_dict(self.generator),
        }

    def load_state_dict(self, state_dict: dict, path="checkpoint") -> None:
        """Restore a `state_dict()` in place, on this state's device.
        Raises ValueError (and changes nothing) when its generator state
        is missing or of another device type, or its structure differs."""
        ckpt.check_generator(state_dict, self.generator)
        ckpt.check_structure(self.state_dict(), state_dict, path)
        device = self.buffer.obs.device
        ckpt.load_params_state_dict(self.model.param_tree(), state_dict["params"])
        ckpt.load_params_state_dict(self.target.param_tree(), state_dict["target_params"])
        self.opt.load_state_dict(self.model.param_tree(), state_dict["opt_state"])
        buf = state_dict["buffer"]
        names = ("obs", "actions", "rewards", "dones", "filled", "action_mask")
        ckpt.load_leaves([getattr(self.buffer, k) for k in names if buf[k] is not None],
                         [ckpt.local_slots(buf[k], self.shard, self.buffer.n_envs, device)
                          for k in names if buf[k] is not None])
        self.buffer.pos = int(buf["pos"])
        self.ret_rms = ckpt.load_dataclass(RunningMeanStd, state_dict["ret_rms"], device)
        self.reward_stream = ckpt.load_dataclass(
            RewardStream, ckpt.local_envs(state_dict["reward_stream"], self.shard, device), device)
        self.env_steps = int(state_dict["env_steps"])
        self.updates = int(state_dict["updates"])
        self.last_target_update = int(state_dict["last_target_update"])
        ckpt.load_generator(self.generator, state_dict)


def refuse_units(n_units: int) -> None:
    if n_units > 1:
        raise NotImplementedError(
            f"a train state of {n_units} sweep units has no checkpoint: a sweep does not checkpoint "
            "(neither does the JAX package's vmapped sweep); run one unit through codebase_tpu_torch.run"
        )


def build_train_functions(env: Environment, eval_env: Environment, cfg, time_limit: int, device, hypers=None,
                          shard=None, debug=False):
    """Construct (init_state(seed), train_iteration(state), evaluate(state,
    generator)). cfg is the `algorithm` config node. `train_iteration.update
    (state, batch, active=None)` is one update on a reference-layout batch.

    `debug` runs each train iteration under `utils/debug.checks()` (NaN,
    index and division errors raised with the op and its source line, the
    GRU kernels' outputs scanned) and, as the JAX package does, logs a loss
    of 0.0 where no update happened instead of the NaN sentinel, so that
    the NaN checks stay meaningful: the rows of a debug run before
    `training_start` log loss 0.0.

    `hypers`, one {"lr"|"gamma"|"tau": value} dict per unit (None: one unit
    with the config's values), makes a sweep group: `init_state(seeds)`
    then takes one seed per unit. Each unit's weights come from a host
    generator seeded with its seed, as a one-unit run's do; the group's
    device generator (rollouts, exploration, replay sampling) is seeded
    with the first unit's seed, so one unit reproduces a plain run and a
    unit's draws do not depend on the other units' seeds. E is each unit's
    env count, and `updates_per_collect: auto` is E.

    `shard` (`parallel/mesh.py`) makes this one rank of a data-parallel
    run. Mode env: the rank steps its E/W of the E envs (`parallel_envs`),
    keeps its replay slots, takes the loss of its B/W rows of each update
    and sums the gradients over the ranks; losses and env steps are the
    whole run's on every rank, and evals run whole on every rank. Mode unit
    (a sweep over ranks): `hypers` are this rank's units and
    `init_state(seeds, generator_seed)` takes the whole group's first
    seed; the draws and the host decisions are the whole group's."""
    acfg = cfg
    lrs, gammas, taus = unit_hypers(acfg, hypers or [{}])
    U = len(lrs)
    lead = (U,) if U > 1 else ()
    n_envs = int(acfg.get("parallel_envs", 1))
    batch_size = int(acfg.batch_size)
    splits = shard is not None and shard.splits_envs
    if splits and U > 1:
        raise ValueError("a sweep group shards its units over the ranks (mode unit), not its envs")
    local_envs = shard.local(n_envs, "parallel_envs") if splits else n_envs
    if splits:
        shard.local(batch_size, "batch_size")
    eval_shard = shard if shard is not None and shard.mode == "unit" else None
    # round the episode capacity up to a multiple of the insert width, as
    # the JAX package does
    buffer_size = -(-int(acfg.buffer_size) // n_envs) * n_envs
    updates_per_collect = acfg.get("updates_per_collect", "auto")
    n_updates = n_envs if updates_per_collect == "auto" else int(updates_per_collect)
    tau = float(acfg.target_update_interval_or_tau)  # the regime; each unit's value is in taus
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
    early_exit = resolve_early_exit(early_exit_option(acfg), env, n_envs)
    no_update_loss = 0.0 if debug else math.nan  # the logger's nanmean skips a NaN

    def init_state(seed, generator_seed=None) -> DQNTrainState:
        seeds = [int(s) for s in (seed if isinstance(seed, (list, tuple)) else [seed])]
        if len(seeds) != U:
            raise ValueError(f"init_state takes one seed per unit: {U} units, {len(seeds)} seeds")
        init_gens = [torch.Generator().manual_seed(s) for s in seeds]  # weights, made on the host
        model = DQNModel.create(env, acfg.model, acfg, generator=init_gens, device=device, gamma=gammas)
        target = copy.deepcopy(model).requires_grad_(False)
        zeros = pack_units(np.zeros(U, np.int64))
        return DQNTrainState(
            model=model,
            target=target,
            opt=make_optimizer(acfg.optimizer, model.param_leaves(), pack_units(lrs), acfg.grad_clip,
                               clip_mask=model.clip_mask(), n_units=U),
            buffer=replay_init(
                buffer_size, time_limit, env.n_agents, env.obs_dim, env.n_actions,
                with_mask=env.has_action_mask, obs_dtype=obs_dtype, device=device, n_units=U,
                shard=shard, n_envs=n_envs,
            ),
            generator=torch.Generator(device=device).manual_seed(seeds[0] if generator_seed is None
                                                                 else int(generator_seed)),
            ret_rms=model.init_rms(device),
            reward_stream=RewardStream.init(U * local_envs, env.n_agents, device) if reward_plan else None,
            env_steps=zeros,
            updates=zeros,
            last_target_update=zeros,
            shard=shard,
        )

    def update(state: DQNTrainState, batch: dict, active=None):
        """One gradient update, then target maintenance, for the units
        marked in `active` (host bools; None: all). The others keep their
        params, moments, counters and target. Returns the (U,) losses."""
        active = np.ones(U, bool) if active is None else np.asarray(active, bool)
        model = state.model
        params = model.param_leaves()
        losses, ret_rms = model.unit_losses(state.target, batch, state.ret_rms, shard)
        grads = torch.autograd.grad(losses.sum(), params)
        if shard is not None:
            grads = shard.sum_grads(grads)  # the whole batch's gradient on every rank
        with profiling.span("dqn/optimizer"):
            state.opt.step(grads, active)
        state.ret_rms = ret_rms if active.all() else ret_rms.where(
            torch.tensor(active, device=ret_rms.count.device), state.ret_rms)
        updates = unit_values(state.updates, U) + active
        state.updates = pack_units(updates)
        if tau > 1.0:
            last = unit_values(state.last_target_update, U)
            hard = active & (updates - last >= taus)
            hard_update(state.target.param_leaves(), params, hard)
            state.last_target_update = pack_units(np.where(hard, updates, last))
        elif tau < 1.0:
            soft_update(state.target.param_leaves(), params, unit_scalar(taus, 2, params[0]), active)
        return losses.detach()

    def train_iteration(state: DQNTrainState) -> dict:
        # the spans below are what `codebase_tpu_torch.profile` reads
        profiling.count("dqn/iterations")
        env_steps = unit_values(state.env_steps, U)
        epsilon = pack_units(np.array([eps_sched(s) for s in env_steps]))
        with profiling.span("dqn/rollout"):
            rollout, _ = collect_episodes(
                env,
                state.model.policy(epsilon),
                state.model.critic.init_hiddens(local_envs),
                state.generator,
                U * local_envs,
                time_limit,
                bool(acfg.use_proper_termination),
                early_exit,
                shard,
            )
        if reward_plan is not None:
            with profiling.span("dqn/reward_stream"):
                # persistent streaming standardisation of the raw rewards
                state.reward_stream, rewards = apply_plan(
                    reward_plan, state.reward_stream, rollout.stat_rewards, rollout.filled
                )
                rollout = dataclasses.replace(rollout, rewards=rewards)
        with profiling.span("dqn/replay_add"):
            replay_add(state.buffer, rollout, slot_reuse)
            filled = rollout.filled.reshape(time_limit, U, local_envs).sum((0, 2))
            if shard is not None:
                filled = shard.env_sum(filled)  # the whole run's steps
            with profiling.host_sync("sync/replay_filled"):
                filled = filled.cpu()
            env_steps = env_steps + filled.numpy().astype(np.int64)
            state.env_steps = pack_units(env_steps)

        # each unit trains once it is past training_start (the group draws
        # the batches when any unit does, of any rank)
        can_update = (env_steps > int(acfg.training_start)) & state.buffer.can_sample(batch_size)
        any_update = bool(can_update.any())
        if shard is not None:
            any_update = shard.any(any_update)
        if any_update:
            with profiling.span("dqn/updates"):
                with profiling.span("dqn/sample"):  # ONE gather for all updates of this iteration
                    batches = replay_sample_many(state.buffer, state.generator, batch_size, n_updates, shard)
                losses = [
                    update(state, batch_to_reference_layout(
                        {k: (v[u] if v is not None else None) for k, v in batches.items()}, U
                    ), can_update)
                    for u in range(n_updates)
                ]
                loss = torch.stack(losses).mean(0)
                if shard is not None:
                    loss = shard.env_sum(loss, "loss")  # the ranks' rows' shares
                if not can_update.all():
                    loss = torch.where(torch.tensor(can_update, device=loss.device), loss, no_update_loss)
                loss = loss.reshape(lead)
        else:
            loss = torch.full(lead, no_update_loss)  # "no update happened"
        return {
            "loss": loss,
            "epsilon": epsilon,
            # this rank's envs (`parallel.mesh.fetch_metrics` gathers them)
            "episode_returns": rollout.episode_returns,  # (U*E, N)
            "episode_lengths": rollout.episode_lengths,  # (U*E,)
        }

    def evaluate(state: DQNTrainState, generator: torch.Generator) -> dict:
        """Rollouts on the eval env at `eps_evaluation`, `eval_episodes` for
        each unit (unit-major). A data-parallel run evaluates whole on every
        rank; a sweep's rank its own units."""
        n = int(acfg.eval_episodes)
        rollout, _ = collect_episodes(
            eval_env,
            state.model.policy(float(acfg.eps_evaluation)),
            state.model.critic.init_hiddens(n),
            generator,
            U * n,
            time_limit,
            early_exit=resolve_early_exit("auto", eval_env, n),
            shard=eval_shard,
        )
        return {"episode_returns": rollout.episode_returns, "episode_lengths": rollout.episode_lengths}

    # the update on a given batch, for callers that lay out their own
    # (the parity tests)
    train_iteration.update = update
    if debug:
        train_iteration = debug_checks.checked(train_iteration)
    return init_state, train_iteration, evaluate
