"""The card-against-CPU checks (`codebase_tpu_torch/card_vs_cpu.py`) on the
CPU, and the JAX package's numbers they hold the card's delivery rates to.

`docs/gate_evidence/port_h100/ia2c_rware/card_rates.json` holds the JAX
package's delivery count of a uniform random policy on rware-tiny-2ag-v2
(2048 whole episodes, T=500; one count for each of 9 keys) and its eval
CLI's score of a vendored port checkpoint (2000 episodes); the tests below
re-derive them from the JAX package. `PYTHONPATH=. python
tests/test_torch_card_rates.py` writes the file.

The checks themselves run here cpu against cpu at a small size: the env
steps of the three envs, the gate's IA2C updates, and the draw checks.
"""

import json
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from codebase_tpu_torch import card_vs_cpu

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
RATES = card_vs_cpu.RATES
# the JAX side of the random-policy count: tests/test_torch_rware.py's protocol
# (one key a run; the port's seeds are as many independent samples)
RANDOM_POLICY = {"env": "rware-tiny-2ag-v2", "envs": 2048, "steps": 500, "jax_keys": list(range(1, 10)),
                 "port_seeds": list(range(1, 10))}
CHECKPOINT = {"run_dir": "docs/gate_evidence/port_h100/ia2c_rware/checkpoint_seed1", "episodes": 2000, "seed": 0}


def jax_random_policy_deliveries(envs, steps, key) -> float:
    """Deliveries of `envs` whole episodes under a uniform random policy,
    all draws from `jax.random.PRNGKey(key)`: reset, actions, step."""
    from codebase_tpu.envs.factory import make_env as jax_make_env

    jenv = jax_make_env(RANDOM_POLICY["env"], time_limit=steps)
    key, k = jax.random.split(jax.random.PRNGKey(key))
    jstate, _ = jenv.reset_batch(k, envs)
    jstep = jax.jit(jenv.step_batch)
    total = 0.0
    for _ in range(steps):
        key, ka, ks = jax.random.split(key, 3)
        jstate, jts = jstep(jstate, jax.random.randint(ka, (envs, jenv.n_agents), 0, jenv.n_actions), ks)
        total += float(np.asarray(jts.reward).sum())
    return total


def jax_eval(run_dir, episodes, seed) -> dict:
    """`codebase_tpu/eval.py`'s CLI on a run dir: the mean, std and sum of
    the episodes' returns (summed over agents)."""
    from codebase_tpu import eval as jax_eval_cli

    returns = np.asarray(jax_eval_cli.main([f"path={REPO / run_dir}", f"eval_episodes={episodes}",
                                            f"seed={seed}"])).sum(-1)
    return {"episodes": int(returns.shape[0]), "mean": float(returns.mean()), "std": float(returns.std()),
            "deliveries": float(returns.sum())}


def write_rates() -> dict:
    rp = dict(RANDOM_POLICY)
    rp["jax_deliveries"] = [jax_random_policy_deliveries(rp["envs"], rp["steps"], k) for k in rp["jax_keys"]]
    ce = dict(CHECKPOINT)
    ce["checkpoint"] = sorted(p.name for p in (REPO / ce["run_dir"] / "checkpoints").glob("*.msgpack"))[-1]
    ce["jax"] = jax_eval(ce["run_dir"], ce["episodes"], ce["seed"])
    rates = {"random_policy": rp, "checkpoint_eval": ce,
             "made_by": "PYTHONPATH=. python tests/test_torch_card_rates.py (the JAX package on the CPU)"}
    RATES.write_text(json.dumps(rates, indent=1) + "\n")
    return rates


@pytest.mark.parametrize("i", range(len(RANDOM_POLICY["jax_keys"])))
def test_vendored_random_policy_count_rederives_from_the_jax_package(i):
    rp = json.loads(RATES.read_text())["random_policy"]
    assert {k: rp[k] for k in RANDOM_POLICY} == RANDOM_POLICY and len(rp["jax_deliveries"]) == len(rp["jax_keys"])
    assert jax_random_policy_deliveries(rp["envs"], rp["steps"], rp["jax_keys"][i]) == rp["jax_deliveries"][i]
    assert rp["jax_deliveries"][i] > 10  # a random policy delivers


def test_vendored_checkpoint_eval_rederives_from_the_jax_eval_cli():
    ce = json.loads(RATES.read_text())["checkpoint_eval"]
    assert {k: ce[k] for k in CHECKPOINT} == CHECKPOINT
    assert (REPO / ce["run_dir"] / "checkpoints" / ce["checkpoint"]).exists()
    assert jax_eval(ce["run_dir"], ce["episodes"], ce["seed"]) == pytest.approx(ce["jax"], rel=1e-6)


@pytest.mark.parametrize("name", sorted(card_vs_cpu.ENV_CASES))
def test_env_steps_cpu_against_cpu(name):
    _, _, T, rtol = card_vs_cpu.ENV_CASES[name]
    out = card_vs_cpu.env_steps(name, 64, 20, T, "cpu", rtol)
    assert out["bitwise"] and out["steps"] == 20
    if name.startswith("rware"):
        assert out["deliveries"] >= 16 and out["pickups"] > 0


def test_env_steps_name_the_first_step_and_field_that_differ(monkeypatch):
    """A difference in one device's step is caught at its step and field."""
    from codebase_tpu_torch.envs.lbforaging import LevelBasedForaging

    step = LevelBasedForaging.step_batch
    calls = {"n": 0}

    def off_by_one(self, state, actions, generator=None, current_mask=None):
        new, ts = step(self, state, actions, generator, current_mask)
        calls["n"] += 1
        if calls["n"] == 7:  # the second device's 4th step
            new.agent_r = new.agent_r.clone()
            new.agent_r[0, 3] += 1
        return new, ts

    monkeypatch.setattr(LevelBasedForaging, "step_batch", off_by_one)
    with pytest.raises(AssertionError, match=r"step 3 state\.inner\.agent_r differs first at \[0, 3\]"):
        card_vs_cpu.env_steps("lbforaging:Foraging-8x8-2p-3f-v3", 8, 6, 25, "cpu")


def test_ia2c_updates_cpu_against_cpu():
    out = card_vs_cpu.ia2c_updates("cpu", n_updates=3, T=20)
    assert out["envs"] == 10 and out["n_steps"] == 5 and len(out["max_rel_by_update"]) == 3
    assert max(out["max_rel"].values()) == 0.0 and set(out["params_max_rel"]) == {"after_update_1", "after_update_3"}


def test_draw_checks_on_the_cpu():
    out = card_vs_cpu.draw_checks("cpu", n=2**14, reset_envs=2**12)
    assert out["sample"]["counts"][3] == 0 and out["gumbel_argmax"]["exponential_zeros"] == 0
    assert all(v["chi2_p"] >= card_vs_cpu.P_MIN for k, v in out["reset_batch"].items() if k != "envs")


def test_chi2_p_is_the_chi_square_survival_function():
    # 2 degrees of freedom: p = exp(-stat / 2)
    counts, probs = [30, 50, 20], [1 / 3] * 3
    expected = 100 / 3
    stat = sum((c - expected) ** 2 / expected for c in counts)
    assert card_vs_cpu.chi2_p(counts, probs) == pytest.approx(math.exp(-stat / 2), rel=1e-9)


def test_delivery_counts_beyond_four_sd_fail():
    assert card_vs_cpu._poisson_check("counts", 64.0, 36.0)["z"] == pytest.approx(2.8)
    with pytest.raises(AssertionError, match="beyond 4.0 sd"):
        card_vs_cpu._poisson_check("counts", 90.0, 40.0)


def test_a_biased_draw_fails_its_test():
    with pytest.raises(AssertionError, match="chi-square"):
        card_vs_cpu._test("biased", [600, 400], [0.5, 0.5])


if __name__ == "__main__":
    print(json.dumps(write_rates(), indent=1))
    sys.exit(0)
