"""`correct`: a sound run passes, each fault the cells can have fails, and
so does the control (the reference in TF32 in the program's place)."""

import numpy as np
import pytest
import torch

from portbench import check, run, spec
from portbench.reference import lbf as ref_lbf
from portbench.tests.tiny import tiny_workload

SEED = 2**33 + 11


def tiny_run(**kw):
    result, lines = run.run_cell("idqn_rnn_lbf.collect", SEED, 0.5, False, "cpu", workload=tiny_workload(), **kw)
    return result


def test_sound_run_is_correct():
    result = tiny_run()
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] >= 1
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}  # no card: no memory reading


def test_state_left_unchanged_is_caught(monkeypatch):
    from codebase_tpu_torch.algos import common

    monkeypatch.setattr(common.Optimizer, "step", lambda self, grads, active=None: None)
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["change_gap"][0] == pytest.approx(1.0)


def test_half_batch_is_caught(monkeypatch):
    from codebase_tpu_torch.algos import dqn

    whole = dqn.DQNModel.unit_losses

    def half(self, target, batch, ret_rms, shard=None):
        h = batch["filled"].shape[-1] // 2
        batch = {k: (None if v is None else (v[..., :h] if k in ("dones", "filled") else v[:, :, :h]))
                 for k, v in batch.items()}
        return whole(self, target, batch, ret_rms, shard)

    monkeypatch.setattr(dqn.DQNModel, "unit_losses", half)
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["loss_gap"][0] > result["checks"]["loss_gap"][1]


@pytest.mark.parametrize("fault", ["missing", "from_target"])
def test_wrong_target_copy_is_caught(monkeypatch, fault):
    """A hard target copy that never comes, or that copies the target onto
    itself, fails `target_copy_gap`."""
    from codebase_tpu_torch.algos import dqn

    copy = dqn.hard_update
    if fault == "missing":
        monkeypatch.setattr(dqn, "hard_update", lambda target, source, units=None: None)
    else:
        monkeypatch.setattr(dqn, "hard_update", lambda target, source, units=None: copy(target, target, units))
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["target_copy_gap"][0] > 0 and result["checks"]["target_schedule"][0] == 0


def test_altered_observation_is_caught(monkeypatch):
    from dataclasses import replace

    from codebase_tpu_torch.envs import lbforaging

    step = lbforaging.LevelBasedForaging.step_batch

    def altered(self, state, actions, generator=None, current_mask=None):
        state, ts = step(self, state, actions, generator, current_mask)
        obs = ts.obs.clone()
        obs[:, 1, -1] += 1.0  # agent 1 sees player 2's level one higher
        return state, replace(ts, obs=obs)

    monkeypatch.setattr(lbforaging.LevelBasedForaging, "step_batch", altered)
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["env_mismatch"][0] > 0


def test_altered_q_value_is_caught(monkeypatch):
    from codebase_tpu_torch.models import multi_agent

    forward = multi_agent.MultiAgentNetwork.forward

    def altered(self, x, h=None):
        q, h = forward(self, x, h)
        return q * (1.0 + 1e-3), h

    monkeypatch.setattr(multi_agent.MultiAgentNetwork, "forward", altered)
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["q_gap"][0] > result["checks"]["q_gap"][1]


@pytest.mark.parametrize("mode", ["control", "half_batch"])
def test_reference_in_the_programs_place_fails(mode):
    workload = tiny_workload()
    config = spec.config(workload["config"])
    cell = run.Cell(workload, config, SEED, "cpu")
    cell.free()
    correct, checks = check.verdict(cell.judge(mode), config["limits"])
    assert not correct, checks


def _random_play(K, T, seed, load_share=None):
    """The port's LBF 8x8-2p-3f stepped with random actions (LOAD with
    probability `load_share` where given), padded episode-major numpy
    arrays as the check takes them."""
    from codebase_tpu_torch.envs.factory import make_env

    env = make_env("lbforaging:Foraging-8x8-2p-3f-v3", time_limit=T)
    gen = torch.Generator().manual_seed(seed)
    state, ts = env.reset_batch(gen, K)
    obs, acts, rews, dones = [ts.obs], [], [], []
    running = torch.ones(K, dtype=torch.bool)
    filled = []
    for _ in range(T):
        a = torch.randint(0, 6, (K, 2), generator=gen)
        if load_share is not None:
            a = torch.where(torch.rand((K, 2), generator=gen) < load_share, ref_lbf.LOAD, a)
        state, ts = env.step_batch(state, a, gen)
        m = running.float()
        obs.append(ts.obs * m[:, None, None])
        acts.append(a * running[:, None])
        rews.append(ts.reward * m[:, None])
        dones.append(ts.done.float() * m)
        filled.append(m)
        running = running & ~ts.done
    return {"obs": torch.stack(obs, 1).numpy(), "actions": torch.stack(acts, 1).numpy(),
            "rewards": torch.stack(rews, 1).numpy(),
            "dones": np.concatenate([np.zeros((K, 1), np.float32), torch.stack(dones, 1).numpy()], 1),
            "filled": torch.stack(filled, 1).numpy()}


LBF_ENV = spec.config("idqn_rnn_lbf")["reference"]["env"]


def test_reference_env_agrees_with_the_port_on_random_play():
    """The port's LBF, stepped with random actions, against the rules."""
    x = _random_play(200, 25, 5)
    bad, faults, first = ref_lbf.check_episodes(LBF_ENV, x["obs"], x["actions"], x["rewards"], x["dones"],
                                                x["filled"])
    assert (bad, faults) == (0, 0), first
    assert float(x["rewards"].sum()) > 0  # some food was collected


def test_bulk_step_check_agrees_with_the_port_on_random_play():
    """Every transition of a batch of the port's episodes, in bulk, against
    the rules: episodes that end early (all food collected), rewards shared
    by loaders, moves that collide."""
    x = _random_play(400, 25, 6, load_share=0.4)
    assert ref_lbf.check_steps(LBF_ENV, **x) == (0, None)
    assert ref_lbf.check_episodes(LBF_ENV, **x)[:2] == (0, 0)
    assert (x["filled"].sum(1) < 25).sum() >= 3 and float(x["rewards"].sum()) > 0


def _first_live(x, *, ended):
    """An episode that ended before the last step (or ran to it) and one of
    its live steps."""
    lengths = x["filled"].sum(1)
    k = int(np.nonzero((lengths < 25) if ended else (lengths == 25))[0][0])
    return k, int(lengths[k]) - 1


def _fault(x, fault):
    k, t = _first_live(x, ended=fault in ("done late", "padded action"))
    if fault == "observation":
        x["obs"][k, t + 1, 1, -1] += 1.0  # agent 1 sees player 2's level one higher
    elif fault == "reward":
        x["rewards"][k, t, 0] += 1e-3
    elif fault == "done early":
        x["dones"][k, t] = 1.0
    elif fault == "done late":
        x["dones"][k, t + 1] = 0.0
    elif fault == "filled":
        x["filled"][k, t] = 0.0
    elif fault == "padded action":
        x["actions"][k, t + 1, 0] = 3
    elif fault == "action out of range":
        x["actions"][k, 0, 1] = 6
    elif fault == "first observation":
        x["obs"][k, 0, 1, 0] += 1.0  # agent 1 sees the first food one row lower
    elif fault == "state unchanged":
        x["obs"][k, 1:] = x["obs"][k, :1] * x["filled"][k][:, None, None]


@pytest.mark.parametrize("fault", ["observation", "reward", "done early", "done late", "filled", "padded action",
                                   "action out of range", "first observation", "state unchanged"])
def test_bulk_step_check_finds_what_the_replay_finds(fault):
    """One entry of one env made wrong: the bulk check and the replay of
    the episode both count it."""
    x = _random_play(400, 25, 6, load_share=0.4)
    _fault(x, fault)
    bad, first = ref_lbf.check_steps(LBF_ENV, **x)
    assert bad > 0 and first
    assert ref_lbf.check_episodes(LBF_ENV, **x)[0] > 0


def test_bulk_reset_faults_count_as_the_episode_does():
    """Reset faults of first observations, in bulk and one at a time."""
    rows = [
        [2, 2, 1, 5, 5, 2, -1, -1, 0, 0, 0, 1, 7, 7, 2],  # sound
        [2, 2, 1, 5, 5, 2, -1, -1, 0, 3, 3, 1, 3, 3, 2],  # players share a cell
        [0, 2, 1, 2, 3, 3, 3, 3, 1, 0, 0, 4, 7, 7, 2],  # food on the border, too high, foods touch, level 4
        [2, 2, 1, 6, 6, 1, -1, -1, 0, 2, 2, 1, 7, 8, 0],  # food on a player, player off the grid at level 0
    ]
    obs0 = np.asarray(rows, np.float32)
    want = [len(ref_lbf.Episode(8, 8, 2, 3, 8, 25, 50, o[None]).reset_faults()) for o in obs0]
    players, foods, active = ref_lbf._decode(torch.as_tensor(obs0), 3, 2)
    assert ref_lbf._reset_faults(LBF_ENV, players, foods, active).tolist() == want
    assert want[0] == 0 and min(want[1:]) > 0


def test_smaclite_reference_agrees_with_the_port_on_random_play():
    """The port's SMAClite MMM2, stepped with random valid actions, against
    the rules, from the port's reset states."""
    from codebase_tpu_torch.envs.factory import make_env

    from portbench.reference import smaclite as ref_smaclite

    ref_env = spec.config("qmix_rnn_mmm2")["reference"]["env"]
    env = make_env("smaclite:MMM2-v0", time_limit=ref_env["time_limit"], wrappers=["CooperativeReward"])
    gen = torch.Generator().manual_seed(7)
    K, T = 24, 120
    state, ts = env.reset_batch(gen, K)
    inner = env.inner_state(state)
    resets = [{k: v[..., e].numpy() for k, v in vars(inner).items() if k != "t"} for e in range(K)]
    obs, masks, acts, rews, dones, filled = [ts.obs], [ts.action_mask], [], [], [], []
    running = torch.ones(K, dtype=torch.bool)
    for _ in range(T):
        logits = torch.where(ts.action_mask > 0, torch.rand(ts.action_mask.shape, generator=gen), -1.0)
        a = logits.argmax(-1)
        state, ts = env.step_batch(state, a, gen, ts.action_mask)
        m = running.float()
        obs.append(ts.obs * m[:, None, None])
        masks.append(torch.where(running[:, None, None], ts.action_mask, torch.ones_like(ts.action_mask)))
        acts.append(a * running[:, None])
        rews.append(ts.reward * m[:, None])
        dones.append(ts.done.float() * m)
        filled.append(m)
        running = running & ~ts.done
    bad, faults, first = ref_smaclite.check_episodes(
        ref_env, torch.stack(obs, 1).numpy(), torch.stack(acts, 1).numpy(), torch.stack(rews, 1).numpy(),
        np.concatenate([np.zeros((K, 1), np.float32), torch.stack(dones, 1).numpy()], 1),
        torch.stack(filled, 1).numpy(), torch.stack(masks, 1).numpy(), resets)
    assert (bad, faults) == (0, 0), first
    assert float(torch.stack(rews).sum()) > 0 and bool((torch.stack(filled).sum(0) < T).all())  # combat, and ends


def test_mixer_reference_agrees_with_the_port():
    from codebase_tpu_torch.models.mixers import QMixer

    from portbench.reference import qnet

    mixer = QMixer(n_agents=10, state_dim=1660, embed_dim=64, hypernet_layers=2, hypernet_embed=32,
                   generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    qs, states = torch.randn((10, 5, 7), generator=gen), torch.randn((5, 7, 1660), generator=gen)
    tree = {k: v for k, v in mixer.param_tree().items()}
    torch.testing.assert_close(qnet.qmix(tree, qs, states), mixer(qs, states).detach(), rtol=1e-5, atol=1e-5)


def test_qmix_sound_run_is_correct():
    workload = {"name": "qmix_rnn_mmm2.tiny", "config": "qmix_rnn_mmm2", "chips": 1, "why": "a test's size",
                "traffic": {"parallel_envs": 16, "batch_size": 8, "updates_per_collect": 4, "buffer_size": 16}}
    result, lines = run.run_cell(workload["name"], SEED, 0.1, False, "cpu", workload=workload)
    assert result["correct"], lines
