"""The actor-critic family in the harness: a tiny MAPPO cell is `correct`
through `run_cell`; the control, the planted fault and each fault the cell
can have fail it; the plain reference agrees with the port on seeded
weights, and in blocks with itself whole; a further actor-critic
configuration runs from a configuration file and a workload file alone; and
the DQN family's numbers are the parent harness's, bit for bit."""

import json
import shutil

import pytest
import torch

from portbench import check, run, spec
from portbench.families import ac
from portbench.reference import ac as ref_ac
from portbench.tests.tiny import tiny_workload

SEED = 2**33 + 11
CELL = "mappo_rnn_lbf.collect"


def tiny_run(**kw):
    result, lines = run.run_cell(CELL, SEED, 0.3, False, "cpu", workload=tiny_workload(CELL), **kw)
    return result


def test_sound_run_is_correct():
    result = tiny_run()
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] >= 1
    assert set(result["checks"]) == set(ac.LIMITS)
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}  # no card: no memory reading


@pytest.mark.parametrize("mode", ["control", "half_batch"])
def test_reference_in_the_programs_place_fails(mode):
    workload = tiny_workload(CELL)
    config = spec.config(workload["config"])
    cell = run.Cell(workload, config, SEED, "cpu")
    cell.free()
    correct, checks = check.verdict(cell.judge(mode), config["limits"])
    assert not correct, checks
    failed = {k for k, (v, lim) in checks.items() if v > lim}
    assert failed >= ({"logit_gap", "return_gap", "loss_gap"} if mode == "control" else {"loss_gap", "grad_gap"})


def test_state_left_unchanged_is_caught(monkeypatch):
    from codebase_tpu_torch.algos import common

    monkeypatch.setattr(common.Optimizer, "step", lambda self, grads, active=None: None)
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["change_gap"][0] == pytest.approx(1.0)


def test_half_batch_is_caught(monkeypatch):
    """The loss over the first half of the envs, the mean over them."""
    from codebase_tpu_torch.algos.ac import ACModel

    whole = ACModel.ppo_loss

    def half(self, returns, old_log_probs, obs_in, actions, filled, amask=None, shard=None):
        h = filled.shape[-1] // 2
        return whole(self, returns[:, :h], old_log_probs[:, :h], obs_in[:, :, :h], actions[:, :h], filled[:, :h],
                     None if amask is None else amask[:, :, :h], shard)

    monkeypatch.setattr(ACModel, "ppo_loss", half)
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["loss_gap"][0] > result["checks"]["loss_gap"][1]


def test_argmax_sampler_is_caught(monkeypatch):
    """A policy that takes the most likely action in place of a draw."""
    from codebase_tpu_torch.models import distributions

    monkeypatch.setattr(distributions, "sample", lambda generator, logits, env_dim=None, unit_dim=None:
                        logits.argmax(-1))
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["sample_gap"][0] > result["checks"]["sample_gap"][1]


def test_altered_logit_is_caught(monkeypatch):
    from codebase_tpu_torch.models import multi_agent

    forward = multi_agent.MultiAgentNetwork.forward

    def altered(self, x, h=None):
        y, h = forward(self, x, h)
        return (y * (1.0 + 1e-3) if x.shape[1] == 1 else y), h  # the rollout's step alone

    monkeypatch.setattr(multi_agent.MultiAgentNetwork, "forward", altered)
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["logit_gap"][0] > result["checks"]["logit_gap"][1]


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


def test_altered_env_outside_the_sample_is_caught(monkeypatch):
    """An env step that is wrong in the envs that the sample leaves out
    alone: the episodes of the sample pass, the bulk check of every env's
    transitions does not."""
    from dataclasses import replace

    from codebase_tpu_torch.envs import lbforaging

    workload = tiny_workload(CELL)
    config = json.loads(json.dumps(spec.config(workload["config"])))
    config["reference"]["check_rows"] = 8
    _, sampled = check.sampled_envs(SEED, workload["traffic"]["parallel_envs"], 8)
    outside = torch.ones(workload["traffic"]["parallel_envs"], dtype=torch.bool)
    outside[torch.as_tensor(sampled)] = False
    step = lbforaging.LevelBasedForaging.step_batch

    def altered(self, state, actions, generator=None, current_mask=None):
        state, ts = step(self, state, actions, generator, current_mask)
        if ts.reward.shape[0] != outside.shape[0]:
            return state, ts
        reward = ts.reward + 1e-3 * outside[:, None]
        return state, replace(ts, reward=reward)

    monkeypatch.setattr(lbforaging.LevelBasedForaging, "step_batch", altered)
    result, lines = run.run_cell(CELL, SEED, 0.3, False, "cpu", workload=workload, config=config)
    assert not result["correct"]
    assert result["checks"]["env_mismatch"][0] == 0
    assert result["checks"]["all_env_mismatch"][0] > 0


def test_miscounted_env_steps_are_caught(monkeypatch):
    """An iteration that counts each env's own episode, not the longest."""
    from codebase_tpu_torch.envs.vector import Rollout

    monkeypatch.setattr(Rollout, "episode_lengths", property(lambda self: self.filled.sum(0) - 1.0))
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["step_count"][0] > 0


@pytest.mark.parametrize("fault", ["missing", "from_target", "always"])
def test_wrong_target_copy_is_caught(monkeypatch, fault):
    """A target refresh that never comes, copies the target onto itself,
    or comes in every iteration."""
    from codebase_tpu_torch.algos import ac as program_ac

    copy = program_ac.hard_update
    replacement = {
        "missing": lambda target, source, units=None: None,
        "from_target": lambda target, source, units=None: copy(target, target, units),
        "always": lambda target, source, units=None: copy(target, source),
    }[fault]
    monkeypatch.setattr(program_ac, "hard_update", replacement)
    result = tiny_run()
    assert not result["correct"]
    checks = result["checks"]
    if fault == "always":
        assert checks["target_schedule"][0] > 0
    else:
        assert checks["target_copy_gap"][0] > 0 and checks["target_schedule"][0] == 0


def _small_problem(seed=4, N=2, T=7, B=10, D=15, A=6):
    """Seeded inputs of one rollout: obs (N, T+1, B, D), rewards and
    actions (T, B, N), dones (T+1, B), filled (T, B), episodes ending at
    random steps."""
    gen = torch.Generator().manual_seed(seed)
    ends = torch.randint(2, T + 1, (B,), generator=gen)
    t = torch.arange(T)[:, None]
    filled = (t < ends[None]).float()
    dones = torch.zeros(T + 1, B)
    dones[ends, torch.arange(B)] = (ends < T).float()
    obs = torch.randn((N, T + 1, B, D), generator=gen) * torch.cat([torch.ones(1, B), filled], 0)[None, :, :, None]
    rewards = torch.rand((T, B, N), generator=gen) * filled[..., None]
    actions = torch.randint(0, A, (T, B, N), generator=gen) * filled[..., None].long()
    return {"obs": obs, "rewards": rewards, "dones": dones, "filled": filled, "actions": actions}


def _port_model(seed=5):
    """The port's MAPPO model of the configuration, on the CPU, with the
    harness's seeded weights; (model, target critic, w0, spec)."""
    import copy

    from codebase_tpu_torch.algos.ac import ACModel
    from codebase_tpu_torch.config import load_config
    from codebase_tpu_torch.run import build_envs

    config = spec.config("mappo_rnn_lbf")
    cfg = load_config(run.compose({"traffic": {"parallel_envs": 10}}, config, 0, "cpu"))
    env, _ = build_envs(cfg)
    model = ACModel.create(env, cfg.algorithm.model, cfg.algorithm)
    target = copy.deepcopy(model.critic)
    w0 = check.make_weights(model.param_tree(), {"critic": target.param_tree()}, seed, torch.device("cpu"))
    return model, target, w0, config["reference"]


def test_reference_agrees_with_the_port_on_seeded_weights():
    """Logits, n-step returns from the target critic, the PPO loss and its
    gradients of the port's model against the reference's."""
    model, target, w0, refspec = _port_model()
    x = _small_problem()
    obs_in = x["obs"][:, :-1]
    with torch.no_grad():
        logits, _ = model.actor(obs_in)
        torch.testing.assert_close(logits, ref_ac.network(w0["actor"], obs_in), rtol=1e-5, atol=1e-6)
        returns, _ = model.compute_returns(target, x["obs"], x["rewards"], x["dones"], model.init_rms())
        nv = ref_ac.values(w0["critic"], x["obs"], True)
        ref_returns = ref_ac.nstep_returns(x["rewards"], x["dones"], nv, refspec["n_steps"], refspec["gamma"])
        torch.testing.assert_close(returns, ref_returns, rtol=1e-5, atol=1e-6)
        old_lp, _ = model.log_probs_entropy(obs_in, x["actions"])
    # a perturbed actor, so that the ratio is not 1 and the clip binds in places
    with torch.no_grad():
        for p in model.actor.param_leaves():
            p.mul_(1.3)
    params = {"actor": [p.detach().clone().requires_grad_(True) for p in model.actor.param_leaves()],
              "critic": [p.detach().clone().requires_grad_(True) for p in model.critic.param_leaves()]}
    loss, _ = model.ppo_loss(returns, old_lp, obs_in, x["actions"], x["filled"])
    grads = torch.autograd.grad(loss, model.param_leaves())
    tree = {"actor": _retree(w0["actor"], params["actor"]), "critic": _retree(w0["critic"], params["critic"])}
    ref_loss = ref_ac.block_loss(tree, refspec, obs_in, x["actions"], returns, x["filled"], old_lp)[0] / x["filled"].sum()
    ref_grads = torch.autograd.grad(ref_loss, params["actor"] + params["critic"])
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()), rel=1e-5)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-7)


def _retree(like, leaves):
    """`leaves` in the tree layout of `like` (sorted key order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(like)


def test_blockwise_reference_equals_the_whole():
    model, target, w0, refspec = _port_model()
    x = _small_problem(B=24)
    rollout = dict(x, obs=x["obs"], action_mask=None)
    whole = ref_ac.follow(w0, rollout, refspec, "cpu", block_envs=24)
    blocks = ref_ac.follow(w0, rollout, refspec, "cpu", block_envs=5)
    assert blocks["losses"] == pytest.approx(whole["losses"], rel=1e-5)
    torch.testing.assert_close(blocks["returns"], whole["returns"], rtol=0, atol=0)
    for a, b in zip(blocks["first_grad"], whole["first_grad"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    # Adam's first steps are about lr * sign(g): an element whose gradient is
    # near nought moves by its rounding
    for a, b in zip(blocks["after"], whole["after"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for k in ("drawn", "expected", "variance"):  # f32 probabilities, summed in other orders
        torch.testing.assert_close(blocks["samples"][k], whole["samples"][k], rtol=1e-6, atol=1e-9)


def test_sample_gap_reads_standard_errors():
    probs = torch.tensor([0.5, 0.25, 0.25]).expand(1, 1, 400, 3)  # (N, T, B, A)
    actions = torch.cat([torch.zeros(250), torch.ones(100), 2 * torch.ones(50)]).long().reshape(1, 400, 1)
    s = ref_ac.sample_counts(probs, actions, torch.ones(1, 400))
    # action 2: 50 drawn against 100 expected, variance 400 * 0.25 * 0.75 = 75
    assert ref_ac.sample_gap(s) == pytest.approx(50 / 75**0.5)


def test_harness_iterations_equal_the_dqn_counter():
    from codebase_tpu_torch.utils import profiling

    profiling.reset_counters()
    before = run.ITERATIONS["run"]
    result, _ = run.run_cell("idqn_rnn_lbf.collect", 7, 0.2, False, "cpu", workload=tiny_workload())
    assert result["correct"]
    assert run.ITERATIONS["run"] - before == profiling.counters()["dqn/iterations"] >= 4


AC_CONFIGS = {
    # MAA2C, feed-forward: the A2C step, a centralised critic, no GRU
    "maa2c_lbf": {"preset": "maa2c", "overrides": ["algorithm.rollout_early_exit=off"],
                  "model": {"name": "a2c", "num_epochs": 1},
                  "nets": {"use_rnn": False}, "reference": {"ppo": False, "centralised_critic": True}},
    # IPPO, recurrent: each agent's critic on its own observation
    "ippo_rnn_lbf": {"preset": "ippo", "overrides": ["algorithm.model.actor.use_rnn=true",
                                                     "algorithm.model.critic.use_rnn=true",
                                                     "algorithm.rollout_early_exit=off"],
                     "model": {"name": "ppo"}, "nets": {"use_rnn": True},
                     "reference": {"ppo": True, "centralised_critic": False}},
    # MAPPO on SMAClite MMM2: action masks, ten agents, the env's reference
    # of the QMIX configuration without its team reward
    "mappo_rnn_mmm2": {"preset": "mappo", "env": "smaclite:MMM2-v0", "time_limit": 100, "envs": 8,
                       "overrides": ["algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true"],
                       "model": {"name": "ppo"}, "nets": {"use_rnn": True},
                       "reference": {"ppo": True, "centralised_critic": True, "check_rows": 8,
                                     "env": dict(spec.config("qmix_rnn_mmm2")["reference"]["env"], cooperative=False)}},
}


@pytest.mark.parametrize("name", sorted(AC_CONFIGS))
def test_a_further_ac_configuration_is_two_files(tmp_path, name):
    """A configuration file and a workload file, added to a copy of the
    benchmark, make a cell that runs `correct` with no other edit, and the
    reference in TF32 in the program's place fails it."""
    root = tmp_path / "portbench"
    shutil.copytree(spec.ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    c = json.loads((root / "configs" / "mappo_rnn_lbf.json").read_text())
    extra = AC_CONFIGS[name]
    c.update(name=name, preset=extra["preset"], overrides=extra["overrides"])
    c.update({k: extra[k] for k in ("env", "time_limit") if k in extra})
    c["model"].update(extra["model"])
    c["model"]["critic"]["centralised"] = extra["reference"]["centralised_critic"]
    for net in ("actor", "critic"):
        c["model"][net].update(extra["nets"])
    c["reference"].update(extra["reference"])
    (root / "configs" / f"{name}.json").write_text(json.dumps(c))
    w = {"name": f"{name}.tiny", "config": name, "chips": 1, "traffic": {"parallel_envs": extra.get("envs", 48)},
         "why": "a test's size"}
    (root / "workloads" / f"{name}.tiny.json").write_text(json.dumps(w))
    workload, config = spec.workload(w["name"], root), spec.config(name, root)
    result, lines = run.run_cell(w["name"], SEED, 0.2, False, "cpu", workload=workload, config=config)
    assert result["correct"], "\n".join(lines)
    cell = run.Cell(workload, config, SEED + 1, "cpu")
    cell.free()
    assert not check.verdict(cell.judge("control"), config["limits"])[0]


# `correct`'s numbers of the DQN cells at a test's size on the CPU (one
# thread), as the harness before the families gave them (float.hex; the
# numbers not listed read 0)
QMIX_TINY = {"name": "qmix_rnn_mmm2.tiny", "config": "qmix_rnn_mmm2", "chips": 1, "why": "a test's size",
             "traffic": {"parallel_envs": 16, "batch_size": 8, "updates_per_collect": 4, "buffer_size": 16}}
DQN_NUMBERS = [
    ("idqn_rnn_lbf.collect", SEED, {"loss_gap": "0x1.635297fc012d5p-18", "grad_gap": "0x1.edd95c5ac2a0cp-24",
                                    "change_gap": "0x1.3d28b400bb7e7p-17"}),
    ("idqn_rnn_lbf.collect", 5, {"loss_gap": "0x1.530291ba6e09ep-18", "grad_gap": "0x1.f854d9b688f7dp-24",
                                 "change_gap": "0x1.2ff7e86ac7717p-17"}),
    ("qmix_rnn_mmm2.tiny", SEED, {"loss_gap": "0x1.ee16e0eaaedd4p-16", "grad_gap": "0x1.d76ef12f36260p-24",
                                  "change_gap": "0x1.ed4c13543afafp-18"}),
]


@pytest.mark.parametrize("cell,seed,want", DQN_NUMBERS, ids=[f"{c}-{s}" for c, s, _ in DQN_NUMBERS])
def test_dqn_numbers_are_the_parent_harness(cell, seed, want):
    workload = QMIX_TINY if cell == QMIX_TINY["name"] else tiny_workload(cell)
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, _ = run.run_cell(cell, seed, 0.1, False, "cpu", workload=workload)
    finally:
        torch.set_num_threads(torch_threads)
    got = {k: v[0].hex() for k, v in result["checks"].items()}
    assert {k: got[k] for k in want} == want
    assert all(got[k] == (0.0).hex() for k in got if k not in want)
