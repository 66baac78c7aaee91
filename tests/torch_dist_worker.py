"""Rank functions of the port's data-parallel tests (`test_torch_dist.py`,
`test_torch_multihost.py`), in a module of their own: a spawned rank
imports this module, which imports only the port (not JAX, not the test
modules).

Each function runs in every rank of a group made by
`codebase_tpu_torch.parallel.mesh.spawn` (or in one process, without a
group, for the one-rank reference) and returns small host values.
"""

from __future__ import annotations

import dataclasses

import torch

from codebase_tpu_torch.algos import ac, dqn
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.envs.factory import make_env
from codebase_tpu_torch.envs.vector import Rollout
from codebase_tpu_torch.ops.replay import replay_add
from codebase_tpu_torch.parallel import mesh

DQN = ("idqn", "vdn", "qmix")


def build(argv, sharded: bool):
    """(cfg, init_state, train_iteration, evaluate, shard) on the CPU for a
    small config: `argv` holds `+algorithm=...` and the env keys."""
    cfg = load_config(list(argv))
    env_cfg = cfg.env.to_dict()
    E = int(env_cfg.pop("parallel_envs"))
    cfg.algorithm.parallel_envs = E
    env = make_env(env_cfg.pop("name"), **env_cfg)
    shard = mesh.world() if sharded else None
    family = dqn if cfg.algorithm.name in DQN else ac
    fns = family.build_train_functions(env, env, cfg.algorithm, int(cfg.env.time_limit), torch.device("cpu"),
                                       shard=shard)
    return cfg, fns[0], fns[1], fns[2], shard


def params(state) -> list:
    return [p.detach().numpy().copy() for p in state.model.param_leaves()]


def train(argv, iters: int, sharded: bool = True, seed: int = 0) -> dict:
    """`iters` train iterations; per iteration the (whole-run) loss
    metrics, the episode returns of every env (gathered), the counters;
    then the params and Adam moments, and the replay slots this rank
    holds (their env indices)."""
    cfg, init_state, train_iteration, _, shard = build(argv, sharded)
    state = init_state(seed)
    out = {"loss": [], "returns": [], "env_steps": [], "updates": [], "metrics": []}
    for _ in range(iters):
        m = mesh.fetch_metrics(train_iteration(state), shard)
        out["loss"].append(float(m["loss"]))
        out["metrics"].append({k: float(m[k]) for k in ("actor_loss", "value_loss", "entropy") if k in m})
        out["returns"].append(m["episode_returns"].numpy().copy())
        out["env_steps"].append(int(state.env_steps))
        out["updates"].append(int(state.updates))
    out["params"] = params(state)
    out["adam"] = [t.numpy().copy() for t in state.opt.mu + state.opt.nu]
    out["rank"] = shard.rank if shard is not None else 0
    if hasattr(state, "buffer"):
        out["slots"] = state.buffer.obs.shape[0]
        out["pos"] = state.buffer.pos
    return out


def replay_layout(argv, inserts: int, seed: int = 0) -> dict:
    """The global env index each of this rank's replay slots holds after
    `inserts` inserts of rollouts whose obs are stamped with their env's
    global index, and the slots of the checkpoint's global layout."""
    cfg, init_state, _, _, shard = build(argv, True)
    buf = init_state(seed).buffer
    E, T = int(cfg.algorithm.parallel_envs), int(cfg.env.time_limit)
    El = E // shard.world
    N, D = buf.obs.shape[2:]
    A = buf.action_mask.shape[-1] if buf.action_mask is not None else 1
    stamp = torch.arange(shard.rank * El, (shard.rank + 1) * El, dtype=torch.float32)
    zeros = torch.zeros((T, El, N))
    rollout = Rollout(obs=stamp.reshape(1, El, 1, 1).expand(T + 1, El, N, D), actions=zeros.long(),
                      rewards=zeros, stat_rewards=zeros, dones=torch.zeros((T + 1, El)),
                      filled=torch.ones((T, El)), action_mask=torch.ones((T + 1, El, N, A)))
    state = init_state(seed)
    for _ in range(inserts):
        replay_add(state.buffer, rollout)
    return {"rank": shard.rank, "envs": state.buffer.obs[:, 0, 0, 0].float().tolist(), "pos": state.buffer.pos,
            "global": state.state_dict()["buffer"]["obs"][:, 0, 0, 0].float().tolist()}


def dqn_loss_grads(model_cfg: dict, algo_cfg: dict, env_name: str, params, tparams, batch) -> dict:
    """One DQN loss and gradient on a whole batch held by every rank, each
    rank taking its B/W rows, the gradient summed over the ranks."""
    from codebase_tpu_torch.config import Config
    from codebase_tpu_torch.envs.lbforaging import parse_lbf_name

    shard = mesh.world()
    spec = parse_lbf_name(env_name)
    model = dqn.DQNModel.create(spec, Config(model_cfg), Config(algo_cfg))
    target = dqn.DQNModel.create(spec, Config(model_cfg), Config(algo_cfg))
    model.load_params(params)
    target.load_params(tparams)
    tb = {k: (torch.tensor(v) if v is not None else None) for k, v in batch.items()}
    tb["actions"] = tb["actions"].long()
    loss, rms = model.loss(target, tb, model.init_rms(), shard)
    grads = shard.sum_grads(torch.autograd.grad(loss, model.param_leaves()))
    return {"loss": float(shard.all_reduce(loss.detach().reshape(1))), "grads": [g.numpy().copy() for g in grads],
            "rms": {k: getattr(rms, k).numpy().copy() for k in ("mean", "var", "count")}}


def ppo_loss_grads(model_cfg: dict, algo_cfg: dict, env_name: str, params, returns, old, obs_in, actions,
                   filled) -> dict:
    """One PPO epoch's loss, metrics and gradient on a rollout of E envs,
    each rank taking its E/W envs, the gradient summed over the ranks."""
    from codebase_tpu_torch.config import Config
    from codebase_tpu_torch.envs.lbforaging import parse_lbf_name

    shard = mesh.world()
    model = ac.ACModel.create(parse_lbf_name(env_name), Config(model_cfg), Config(algo_cfg))
    model.load_params(params)
    part = [shard.part(torch.tensor(x), dim) for x, dim in
            ((returns, 1), (old, 1), (obs_in, 2), (actions, 1), (filled, 1))]
    loss, metrics = model.ppo_loss(*part, shard=shard)
    grads = shard.sum_grads(torch.autograd.grad(loss, model.param_leaves()))
    summed = shard.all_reduce(torch.stack([loss.detach()] + [metrics[k] for k in ac.METRICS]))
    return {"loss": float(summed[0]), "metrics": dict(zip(ac.METRICS, summed[1:].tolist())),
            "grads": [g.numpy().copy() for g in grads]}


def helpers() -> dict:
    """The mesh helpers in a rank: the coordinator, a flag raised on rank 1
    only, agreement and disagreement, a draw's slice, and the dtypes the
    collectives carry."""
    shard = mesh.world()
    out = {"rank": shard.rank, "world": shard.world, "coordinator": mesh.is_coordinator(),
           "flag": mesh.sync_flag(shard.rank == 1), "no_flag": mesh.sync_flag(False)}
    mesh.assert_agreement(7, "a constant")
    try:
        mesh.assert_agreement(shard.rank, "the rank")
        out["disagreement"] = None
    except RuntimeError as exc:
        out["disagreement"] = str(exc)
    g = torch.Generator().manual_seed(3)
    out["draw"] = shard.draw(lambda s: torch.rand(s, generator=g), (3, 4), 1).numpy()
    units = dataclasses.replace(shard, mode="unit")
    out["unit_draw"] = units.draw(lambda s: torch.rand(s, generator=g), (2 * 2, 4), 1, 0).numpy()
    dtypes = {}
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.int64):
        t = torch.full((3,), shard.rank + 1, dtype=dt)
        dtypes[str(dt)] = shard.all_reduce(t).tolist()
    out["dtypes"] = dtypes
    return out



def fail_on_rank_1() -> None:
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if mesh.world().rank == 1:
        raise ValueError("rank 1 fails before the collective")
    torch.distributed.barrier()
