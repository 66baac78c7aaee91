"""The frozen yardstick: useful flops and the GRU layer's roofline."""

import ast
from pathlib import Path

import pytest

from portbench import counts

PEAKS = counts.PEAKS[counts.H100_SXM]


def test_useful_flops_count_one_gru_layer():
    """[128, 128] with use_rnn: Linear 15->128, one GRU(128), Linear
    128->6, per agent; two agents; counted by hand."""
    per_agent = 15 * 128 + (128 * 384 + 128 * 384) + 128 * 6
    assert counts.network_macs_per_row(15, [128, 128], 6, True) == per_agent == 100_992
    model = {"obs_dims": [15, 15], "action_dims": [6, 6], "layers": [128, 128], "use_rnn": True}
    rollout, update = counts.useful_flops(model, 25, 1024, 8)
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
