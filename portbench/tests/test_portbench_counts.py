"""The frozen yardstick: useful flops and the GRU layer's roofline."""

import ast
from pathlib import Path

import pytest

from portbench import counts
from portbench.families import dqn

PEAKS = counts.PEAKS[counts.H100_SXM]


def test_useful_flops_count_one_gru_layer():
    """[128, 128] with use_rnn: Linear 15->128, one GRU(128), Linear
    128->6, per agent; two agents; counted by hand."""
    per_agent = 15 * 128 + (128 * 384 + 128 * 384) + 128 * 6
    assert counts.network_macs_per_row(15, [128, 128], 6, True) == per_agent == 100_992
    model = {"obs_dims": [15, 15], "action_dims": [6, 6], "layers": [128, 128], "use_rnn": True}
    rollout, update = dqn.useful_flops(model, 25, 1024, 8)
    assert rollout == 2 * 2 * per_agent == 403_968
    assert update == 8 * 1024 * 26 * 2 * per_agent * 2 * 4


def test_mixer_count_by_hand():
    S, E, HE, N = 20, 64, 32, 2
    hand = (S * HE + HE * N * E) + (S * HE + HE * E) + S * E + (S * E + E) + (N * E + E)
    assert counts.mixer_macs_per_row(N, S, E, 2, HE) == hand


def test_peak_of_f32_is_three_tf32_products():
    assert counts.mfu_peak(PEAKS, "float32") == pytest.approx(165e12)
    assert counts.mfu_peak(PEAKS, "bfloat16") == 989e12


def _chip_smoke_bounds():
    """`chip_smoke.py`'s `bounds()`, taken from its source (the script
    exits on import without a card), bound to the port's fused_gru."""
    from codebase_tpu_torch.ops import fused_gru

    src = (Path(__file__).resolve().parents[2] / "chip_smoke.py").read_text()
    node = next(n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef) and n.name == "bounds")
    scope = {"fg": fused_gru}
    exec(compile(ast.Module(body=[node], type_ignores=[]), "chip_smoke.py", "exec"), scope)
    return scope["bounds"]


@pytest.mark.parametrize("shape", [(2, 1, 262144, 128), (2, 26, 8192, 128), (10, 181, 256, 128)])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_roofline_matches_chip_smoke(shape, direction):
    G, T, B, H = shape
    ms, bound = _chip_smoke_bounds()(f"gru_{direction}", G, T, B, H, 0, PEAKS)
    s, mine = counts.gru_bounds(direction, G, T, B, H, PEAKS)
    assert s * 1e3 == pytest.approx(ms, rel=1e-12) and mine == bound


def _mappo_model():
    from codebase_tpu_torch.config import load_config
    from codebase_tpu_torch.run import build_envs

    from portbench import run, spec
    from portbench.families import ac

    c = spec.config("mappo_rnn_lbf")
    cfg = load_config(run.compose({"traffic": {"parallel_envs": 8}}, c, 0, "cpu"))
    env, _ = build_envs(cfg)
    return ac.network_model(cfg.algorithm, env)


def test_ac_useful_flops_by_hand():
    """MAPPO on LBF: per agent, actor Linear 15->128, GRU(128), Linear
    128->6; centralised critic Linear 30->128, GRU(128), Linear 128->1."""
    from portbench.families import ac

    model = _mappo_model()
    actor = 2 * (15 * 128 + 2 * 128 * 384 + 128 * 6)
    critic = 2 * (30 * 128 + 2 * 128 * 384 + 128 * 1)
    T, E = 25, 65536
    rollout, update = ac.useful_flops(model, T, E)
    assert rollout == 2 * actor
    # target critic over T+1, the pre-update actor over T, 4 epochs of forward and backward of both
    assert update == 2 * E * ((T + 1) * critic + T * actor + 4 * 3 * T * (actor + critic))


def test_ac_gru_calls_are_the_smoke_tests():
    """`chip_smoke.py`'s `train_mappo` phase counts 35 GRU forwards and 8 of
    each backward kernel an iteration at T=25: 25 rollout steps and the
    update's 10."""
    from portbench.families import ac

    model = _mappo_model()
    assert ac.gru_calls(model) == (10, 8)
    assert 25 + ac.gru_calls(model)[0] == 35


def test_ac_gru_call_model_is_the_smoke_tests_bounds():
    """The least time of an iteration at E=8192: the sum of `chip_smoke.py`'s
    bounds at its MAPPO shapes, rollout (g) G=2 T=1 B=8192, AC update (f)
    G=2 T=25 B=8192, target critic (m) G=2 T=26 B=8192."""
    from portbench.families import ac

    model = _mappo_model()
    bounds = _chip_smoke_bounds()
    ms = {}
    for key, kernel, T in [("g", "gru_fwd", 1), ("f_fwd", "gru_fwd", 25), ("f_bwd", "gru_bwd", 25),
                           ("m", "gru_fwd", 26)]:
        ms[key] = bounds(kernel, 2, T, 8192, 128, 0, PEAKS)[0]
    want = 25 * ms["g"] + ms["m"] + ms["f_fwd"] + 4 * 2 * (ms["f_fwd"] + ms["f_bwd"])
    got = ac.gru_least_seconds({"gru_fwd_kernel": 35}, model, 25, 8192, PEAKS)
    assert got * 1e3 == pytest.approx(want, rel=1e-12)
