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
    numbers = check.judge(cell.taps, cell.w0, config["reference"], cell.device, mode)
    correct, checks = check.verdict(numbers, config["limits"])
    assert not correct, checks


def test_reference_env_agrees_with_the_port_on_random_play():
    """The port's LBF, stepped with random actions, against the rules."""
    from codebase_tpu_torch.envs.factory import make_env

    env = make_env("lbforaging:Foraging-8x8-2p-3f-v3", time_limit=25)
    gen = torch.Generator().manual_seed(5)
    K, T = 200, 25
    state, ts = env.reset_batch(gen, K)
    obs, acts, rews, dones = [ts.obs], [], [], []
    running = torch.ones(K, dtype=torch.bool)
    filled = []
    for _ in range(T):
        a = torch.randint(0, 6, (K, 2), generator=gen)
        state, ts = env.step_batch(state, a, gen)
        m = running.float()
        obs.append(ts.obs * m[:, None, None])
        acts.append(a * running[:, None])
        rews.append(ts.reward * m[:, None])
        dones.append(ts.done.float() * m)
        filled.append(m)
        running = running & ~ts.done
    ref_env = spec.config("idqn_rnn_lbf")["reference"]["env"]
    bad, faults, first = ref_lbf.check_episodes(
        ref_env, torch.stack(obs, 1).numpy(), torch.stack(acts, 1).numpy(), torch.stack(rews, 1).numpy(),
        np.concatenate([np.zeros((K, 1), np.float32), torch.stack(dones, 1).numpy()], 1),
        torch.stack(filled, 1).numpy())
    assert (bad, faults) == (0, 0), first
    assert float(torch.stack(rews).sum()) > 0  # some food was collected


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
