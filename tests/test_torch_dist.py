"""Data parallelism of the port (`codebase_tpu_torch/parallel/mesh.py`) over
gloo ranks on the CPU: the counterpart of `tests/test_mesh.py`.

A run over W ranks must compute what the one-rank run of the same seed
computes (the JAX package's `test_single_vs_eight_devices_same_seed_agree`
tolerances: equal counters, losses to rtol 1e-4 and atol 1e-6, returns to
atol 1e-6), with params bitwise equal across the ranks; one update at W=2
must match the JAX package's update on the whole batch (rtol 2e-4). Ranks
are spawned by `mesh.spawn` with a file rendezvous under `tmp_path` (no
TCP port for parallel test workers to race for); a rank that fails stops
the others and the launcher raises. The rank functions live in
`torch_dist_worker.py`, which imports only the port.
"""

import csv
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
import torch_dist_worker as worker

from codebase_tpu.algos.ac import ACModel as JaxACModel
from codebase_tpu.algos.dqn import DQNModel as JaxDQNModel
from codebase_tpu.config import Config as JaxConfig
from codebase_tpu.envs.lbforaging import parse_lbf_name as jax_parse_lbf_name
from codebase_tpu_torch import run
from codebase_tpu_torch import sweep as port_sweep
from codebase_tpu_torch.config import load_config
from codebase_tpu_torch.parallel import mesh
from codebase_tpu_torch.utils.checkpoint import load_checkpoint
from codebase_tpu_torch.utils.params import tree_leaves

torch.set_num_threads(2)
LBF = ["env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5", "env.parallel_envs=8"]
DQN = ["algorithm.training_start=0", "algorithm.buffer_size=32", "algorithm.batch_size=8",
       "algorithm.updates_per_collect=2"]


def _spawn(tmp_path, fn, world, *args):
    return mesh.spawn(fn, world, "cpu", args=args, init_method=f"file://{tmp_path / f'rendezvous_{world}'}")


# ----------------------------------------------------------- the helpers


def test_mesh_from_config_as_the_jax_one(monkeypatch):
    assert mesh.mesh_from_config(None, "cpu") is None
    assert mesh.mesh_from_config(load_config(["+algorithm=idqn"]).get("distributed"), "cpu") is None
    assert mesh.ranks_from_config(None, 4) is None
    assert [mesh.ranks_from_config(n, 4) for n in (1, 3, "all")] == [1, 3, 4]
    with pytest.raises(ValueError, match="need 5 devices, have 4"):
        mesh.ranks_from_config(5, 4)
    # devices 1: a group of one in this process, torn down by `release`
    shard = mesh.mesh_from_config(load_config(["+algorithm=idqn", "distributed.devices=1"]).get("distributed"), "cpu")
    try:
        assert (shard.rank, shard.world, shard.distributed, shard.owned) == (0, 1, True, True)
        assert mesh.is_coordinator() and mesh.sync_flag(True) and not mesh.sync_flag(False)
        mesh.assert_agreement(3, "a value")
    finally:
        mesh.release(shard)
    assert not torch.distributed.is_initialized() and mesh.is_coordinator()
    # N > 1 ranks are spawned by the CLI; `always` needs torchrun's variables
    for var in mesh.TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert mesh.ranks_to_spawn({"devices": 2}, "cpu") == 2
    assert mesh.ranks_to_spawn({"devices": 1}, "cpu") == 0
    with pytest.raises(RuntimeError, match="always needs torchrun's variables"):
        mesh.ranks_to_spawn({"devices": 2, "initialize": "always"}, "cpu")
    with pytest.raises(ValueError, match="auto, always or never"):
        mesh.ranks_to_spawn({"devices": 2, "initialize": "sometimes"}, "cpu")
    with pytest.raises(ValueError, match="need 100000 devices"):
        mesh.ranks_to_spawn({"devices": 100000}, "cpu")


def test_helpers_over_two_ranks(tmp_path):
    """is_coordinator, sync_flag (one rank's flag reaches both),
    assert_agreement (disagreement names each rank's value), a draw at the
    global shape sliced by env or by unit, and the dtypes the replay
    gather sends (bf16 obs, int32 and int64 counters and actions)."""
    r0, r1 = _spawn(tmp_path, worker.helpers, 2)
    assert (r0["coordinator"], r1["coordinator"]) == (True, False)
    assert r0["flag"] and r1["flag"] and not r0["no_flag"] and not r1["no_flag"]
    for r in (r0, r1):
        assert "per-rank values [0, 1]" in r["disagreement"]
    g = torch.Generator().manual_seed(3)
    whole = torch.rand((3, 8), generator=g).numpy()
    np.testing.assert_array_equal(np.concatenate([r0["draw"], r1["draw"]], 1), whole)
    units = torch.rand((8, 4), generator=g).numpy()  # the draw after it, at 4 units' shape
    np.testing.assert_array_equal(np.concatenate([r0["unit_draw"], r1["unit_draw"]], 0), units)
    for r in (r0, r1):
        assert all(v == [3, 3, 3] for v in r["dtypes"].values()), r["dtypes"]


def test_a_failing_rank_stops_the_others_and_raises(tmp_path):
    """Rank 1 raises while rank 0 waits in a barrier: the launcher stops
    rank 0 and raises with rank 1's traceback, long before the collective
    timeout."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails before the collective"):
        _spawn(tmp_path, worker.fail_on_rank_1, 2)
    assert time.perf_counter() - t0 < mesh.TIMEOUT_S / 4


# --------------------------------------------- W ranks = the one-rank run

CASES = {
    # the GRU critic, return standardisation (the moments of the whole
    # batch), the early exit on (a global flag)
    "idqn_gru": ["+algorithm=idqn", *LBF, *DQN, "algorithm.model.use_rnn=true", "algorithm.standardise_returns=true",
                 "algorithm.rollout_early_exit=on"],
    "qmix_std": ["+algorithm=qmix", *LBF, *DQN, "env.standardise_rewards=true"],
    "ia2c_std": ["+algorithm=ia2c", *LBF, "env.standardise_rewards=true", "algorithm.standardise_returns=true"],
    "mappo_gru": ["+algorithm=mappo", *LBF, "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_equal_one_rank(tmp_path, name):
    """The counterpart of `test_single_vs_eight_devices_same_seed_agree`,
    for four train iterations: counters equal, losses (and the AC metrics)
    to rtol 1e-4 / atol 1e-6, every env's returns to atol 1e-6; params and
    Adam moments bitwise equal across the ranks and close to the one-rank
    run's."""
    one = worker.train(CASES[name], 4, sharded=False)
    two = _spawn(tmp_path, worker.train, 2, CASES[name], 4)
    assert max(one["updates"]) > 0
    for r in two:
        assert r["env_steps"] == one["env_steps"] and r["updates"] == one["updates"]
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-4, atol=1e-6)
        for m, m1 in zip(r["metrics"], one["metrics"]):
            assert m.keys() == m1.keys()
            for k in m:
                np.testing.assert_allclose(m[k], m1[k], rtol=1e-4, atol=1e-6, err_msg=k)
        for ret, ret1 in zip(r["returns"], one["returns"]):
            np.testing.assert_allclose(ret, ret1, atol=1e-6)
        for p, p1 in zip(r["params"], one["params"]):
            np.testing.assert_allclose(p, p1, rtol=1e-4, atol=1e-5)
    for a, b in zip(two[0]["params"] + two[0]["adam"], two[1]["params"] + two[1]["adam"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_replay_holds_each_ranks_env_slice(tmp_path, world):
    """Rank r holds exactly the slots its envs fill: after 3 inserts of 8
    envs into a replay of 16 (one wrap), each of its 16/W slots holds one
    of its envs, in the order of its slice; the checkpoint's layout is the
    one-rank run's (slot g holds env g % 8)."""
    argv = ["+algorithm=idqn", *LBF, "algorithm.buffer_size=16", "algorithm.batch_size=8"]
    ranks = _spawn(tmp_path, worker.replay_layout, world, argv, 3)
    El = 8 // world
    for r in ranks:
        mine = list(range(r["rank"] * El, (r["rank"] + 1) * El))
        assert r["envs"] == mine * 2 and r["pos"] == 24
        assert r["global"] == [float(g % 8) for g in range(16)]


# ------------------------------------------------ against the JAX package

ENV = "lbforaging:Foraging-8x8-2p-3f-v3"


def test_dqn_update_at_two_ranks_matches_jax(tmp_path):
    """IDQN with the GRU critic and return standardisation: each rank's
    rows, the summed gradient and the whole batch's loss and moments
    against `jax.value_and_grad` of the JAX loss on the whole batch."""
    model_cfg = dict(name="qnetwork", layers=[128, 128], parameter_sharing=False, use_orthogonal_init=True,
                     use_rnn=True)
    algo_cfg = dict(gamma=0.99, double_q=True, standardise_returns=True)
    jmodel = JaxDQNModel.create(jax_parse_lbf_name(ENV), JaxConfig({**model_cfg, "fused_rnn": "interpret"}),
                                JaxConfig(algo_cfg))
    params = jax.device_get(jax.jit(jmodel.init_params)(jax.random.PRNGKey(0)))
    tparams = jax.device_get(jax.jit(jmodel.init_params)(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    N, T, B, D, A = 2, 5, 8, 15, 6
    lengths = rng.integers(1, T + 1, size=B)
    batch = dict(
        obss=rng.integers(-1, 8, size=(N, T + 1, B, D)).astype(np.float32),
        actions=rng.integers(0, A, size=(N, T, B)).astype(np.int32),
        rewards=(rng.random((N, T, B)) * (rng.random((N, T, B)) < 0.3)).astype(np.float32),
        dones=np.concatenate([np.zeros((1, B)), np.arange(T)[:, None] == lengths[None] - 1], 0).astype(np.float32),
        filled=(np.arange(T)[:, None] < lengths[None]).astype(np.float32),
        action_mask=None,
    )
    jbatch = {k: (jnp.asarray(v) if v is not None else None) for k, v in batch.items()}
    (jloss, jrms), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, tparams, jbatch, jmodel.init_rms()), has_aux=True))(params)
    ranks = _spawn(tmp_path, worker.dqn_loss_grads, 2, model_cfg, algo_cfg, ENV, params, tparams, batch)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=2e-4)
        for g, ref in zip(r["grads"], tree_leaves(jax.device_get(jgrads["critic"]))):
            np.testing.assert_allclose(g, ref, rtol=2e-4, atol=1e-6)
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(r["rms"][k], np.asarray(getattr(jrms, k)), rtol=2e-4, atol=1e-6)
    assert all(np.array_equal(a, b) for a, b in zip(ranks[0]["grads"], ranks[1]["grads"]))


def test_ppo_update_at_two_ranks_matches_jax(tmp_path):
    """MAPPO (recurrent actor, centralised recurrent critic), one clipped
    epoch: each rank's envs, the means over the whole rollout's filled
    steps, the summed gradient against the JAX loss on all envs."""
    net = dict(layers=[128, 128], parameter_sharing=False, use_orthogonal_init=True, use_rnn=True)
    model_cfg = dict(name="ppo", actor=net, critic={**net, "centralised": True})
    algo_cfg = dict(gamma=0.99, n_steps=3, entropy_coef=0.01, value_loss_coef=0.5, standardise_returns=False,
                    num_epochs=4, ppo_clip=0.2)
    jcfg = {**model_cfg, "actor": {**net, "fused_rnn": "interpret"},
            "critic": {**model_cfg["critic"], "fused_rnn": "interpret"}}
    jmodel = JaxACModel.create(jax_parse_lbf_name(ENV), JaxConfig(jcfg), JaxConfig(algo_cfg))
    params = jax.device_get(jax.jit(jmodel.init_params)(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(8)
    N, T, E, D, A = 2, 5, 8, 15, 6
    lengths = rng.integers(1, T + 1, size=E)
    filled = (np.arange(T)[:, None] < lengths[None]).astype(np.float32)
    obs_in = rng.integers(-1, 8, size=(N, T, E, D)).astype(np.float32)
    actions = rng.integers(0, A, size=(T, E, N))
    returns = rng.standard_normal((T, E, N)).astype(np.float32)
    amask = jnp.ones((N, T, E, A))
    jlp, _ = jmodel.log_probs_entropy(params["actor"], jnp.asarray(obs_in), jnp.asarray(actions, jnp.int32), amask)
    old = (np.asarray(jlp) + rng.normal(0, 0.3, size=jlp.shape)).astype(np.float32)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(lambda p: jmodel.ppo_loss(
        p, jnp.asarray(returns), jnp.asarray(old), jnp.asarray(obs_in), jnp.asarray(actions, jnp.int32), amask,
        jnp.asarray(filled)), has_aux=True))(params)
    ranks = _spawn(tmp_path, worker.ppo_loss_grads, 2, model_cfg, algo_cfg, ENV, params, returns, old, obs_in,
                   actions, filled)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=2e-4)
        for k, v in r["metrics"].items():
            np.testing.assert_allclose(v, float(jm[k]), rtol=2e-4, err_msg=k)
        for g, ref in zip(r["grads"], tree_leaves(jax.device_get(jgrads))):
            np.testing.assert_allclose(g, ref, rtol=2e-4, atol=1e-6 * max(1.0, np.abs(ref).max()))


# -------------------------------------------------- the CLI and sweeps

CLI = ["+algorithm=qmix", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5", "env.parallel_envs=8",
       "algorithm.training_start=0", "algorithm.batch_size=4", "algorithm.buffer_size=16",
       "algorithm.eval_interval=200", "algorithm.eval_episodes=2", "device=cpu", "seed=0"]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_run_cli_trains_data_parallel(tmp_path):
    """`python -m codebase_tpu_torch.run ... distributed.devices=2
    device=cpu` trains QMIX end to end over two spawned ranks: one
    results.csv (written by rank 0 alone: one header, one row a cadence),
    the one-rank run's rows."""
    rows, state = run.main(CLI + ["algorithm.total_steps=600", "distributed.devices=2", f"run_dir={tmp_path / 'w2'}"])
    one, _ = run.main(CLI + ["algorithm.total_steps=600", f"run_dir={tmp_path / 'w1'}"])
    assert state is None and len(rows) == len(one) >= 2
    assert _rows(tmp_path / "w2" / "results.csv") == rows
    assert (tmp_path / "w2" / "results.csv").read_text().count("environment_steps") == 1
    for r, r1 in zip(rows, one):
        assert r.keys() == r1.keys() and r["environment_steps"] == r1["environment_steps"]
        for k in r:
            if r[k] and r1[k]:
                np.testing.assert_allclose(float(r[k]), float(r1[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        assert math.isfinite(float(r["mean_episode_returns"]))
    with pytest.raises(ValueError, match=r"env.parallel_envs \(8\) must divide evenly over 3 ranks"):
        run.main(CLI + ["distributed.devices=3", f"run_dir={tmp_path / 'w3'}"])
    assert not (tmp_path / "w3").exists()


def test_checkpoints_move_between_world_sizes(tmp_path):
    """W=2 and W=1 runs from scratch save after the step-60 iteration (the
    global layout) and at the end; a one-rank run resumes from the W=2
    checkpoint and a two-rank run from the W=1 one, each to the same end:
    their rows and final checkpoints are the W=2 run's (replay, reward
    streams, counters and generator exactly, losses and params to the W=2 /
    W=1 tolerances)."""
    argv = ["+algorithm=idqn", *LBF, *DQN, "algorithm.model.use_rnn=true", "env.standardise_rewards=true",
            "algorithm.total_steps=120", "algorithm.log_interval=40", "algorithm.eval_interval=40",
            "algorithm.eval_episodes=2", "algorithm.save_interval=60", "device=cpu", "seed=0"]

    def saved(d):
        return sorted((tmp_path / d / "checkpoints").glob("model_s*.msgpack"), key=lambda p: int(p.stem[7:]))

    run.main(argv + ["distributed.devices=2", f"run_dir={tmp_path / 'w2'}"])
    run.main(argv + [f"run_dir={tmp_path / 'w1'}"])
    assert len(saved("w2")) == 2 and [p.name for p in saved("w1")] == [p.name for p in saved("w2")]
    run.main(argv + [f"run_dir={tmp_path / 'to1'}", f"resume={saved('w2')[0]}"])
    run.main(argv + [f"run_dir={tmp_path / 'to2'}", "distributed.devices=2", f"resume={saved('w1')[0]}"])
    rows = _rows(tmp_path / "w2" / "results.csv")
    end = load_checkpoint(saved("w2")[-1])
    for d in ("to1", "to2"):
        resumed = _rows(tmp_path / d / "results.csv")
        assert resumed and [r["environment_steps"] for r in rows[-len(resumed):]] == [
            r["environment_steps"] for r in resumed]
        for r, ra in zip(resumed, rows[-len(resumed):]):
            np.testing.assert_allclose(float(r["loss"]), float(ra["loss"]), rtol=1e-4, atol=1e-6)
        got = load_checkpoint(saved(d)[-1])
        for k in ("env_steps", "updates", "last_target_update"):
            assert int(got[k]) == int(end[k]), k
        for k, v in end["buffer"].items():
            if v is not None:
                assert torch.equal(torch.as_tensor(got["buffer"][k]), torch.as_tensor(v)), k
        np.testing.assert_array_equal(np.asarray(got["generator"]), np.asarray(end["generator"]))
        for k, v in end["reward_stream"].items():
            np.testing.assert_allclose(np.asarray(got["reward_stream"][k]), np.asarray(v), rtol=1e-6, err_msg=k)
        for x, y in zip(tree_leaves(got["params"]), tree_leaves(end["params"])):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-4, atol=1e-5)


SWEEP = ["+algorithm=idqn", "env.name=matrix-coordination", "env.time_limit=1", "env.parallel_envs=8",
         "algorithm.total_steps=400", "algorithm.training_start=32", "algorithm.buffer_size=256",
         "algorithm.batch_size=16", "algorithm.eval_interval=200", "algorithm.eval_episodes=8", "device=cpu"]


def test_sharded_sweep_units_equal_the_unsharded_group(tmp_path):
    """Four units (2 lr x 2 seeds) over two ranks: each rank trains and
    writes its two units; every unit's rows are the unsharded group's. A
    unit count that does not divide over the ranks raises."""
    variants = [{"lr": 3e-4}, {"lr": 1e-2}]
    whole = port_sweep.run_vmapped_multiseed(load_config(SWEEP), [0, 1], tmp_path / "whole", hyper_variants=variants)
    split = port_sweep.run_vmapped_multiseed(load_config(SWEEP + ["distributed.devices=2"]), [0, 1],
                                             tmp_path / "split", hyper_variants=variants)
    assert [d.relative_to(tmp_path / "split") for d in split] == [d.relative_to(tmp_path / "whole") for d in whole]
    for d, dw in zip(split, whole):
        rows, rows_w = _rows(d / "results.csv"), _rows(dw / "results.csv")
        assert len(rows) == len(rows_w) >= 2
        config, config_w = (yaml.safe_load((x / "config.yaml").read_text()) for x in (d, dw))
        assert config.pop("distributed") == {"devices": 2, "initialize": "auto"}
        config_w.pop("distributed")
        assert config == config_w
        for r, rw in zip(rows, rows_w):
            assert r["environment_steps"] == rw["environment_steps"] and r["updates"] == rw["updates"]
            for k in r:
                if r[k] and rw[k]:
                    np.testing.assert_allclose(float(r[k]), float(rw[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="divide"):
        port_sweep.run_vmapped_multiseed(load_config(SWEEP + ["distributed.devices=2"]), [0, 1, 2],
                                         tmp_path / "odd")
    assert not (tmp_path / "odd").exists()
