"""The yardstick's arithmetic: peaks, multiply-adds, and a GRU layer's least time.

Frozen here so that a change to the program cannot change what it is
measured against.

- `PEAKS`: one NVIDIA H100 SXM (80 GB HBM3), dense rates without sparsity,
  from NVIDIA's data sheet, at the card's full 700 W power limit.
- `network_macs_per_row`, `mixer_macs_per_row`: the multiply-adds of the
  networks that the layers of `RNNSpec` build, and of the QMIX mixer, on one
  row; each family's `useful_flops` (`families/`) counts its rows.
- `gru_bounds`: the least time of one GRU layer call, the larger of its
  operations at the tensor cores' 3xTF32 rate (three TF32 products for each
  f32-accurate product) and its bytes (each input read once, each output
  written once) at the HBM rate. The same rule as the port's `chip_smoke.py`
  `bounds()` and `ops/fused_gru.py` `kernel_flops`/`kernel_bytes`, copied.
"""

from __future__ import annotations

H100_SXM = "NVIDIA H100 80GB HBM3"
PEAKS = {
    H100_SXM: {
        "hbm_bytes_per_s": 3.35e12,
        "fp32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "power_limit_w": 700.0,
    },
}


def peaks_for(device_name: str) -> dict:
    """The peaks of the card `torch.cuda.get_device_name()` names; KeyError
    on a card the table does not hold (no peak is guessed)."""
    return PEAKS[device_name]


def mfu_peak(peaks: dict, dtype: str) -> float:
    """The flop rate a configuration's products are held to: f32 products as
    three TF32 products on the tensor cores (495/3 TFLOP/s), bf16 at the
    dense bf16 rate."""
    if dtype == "float32":
        return peaks["tf32_flops"] / 3.0
    if dtype == "bfloat16":
        return peaks["bf16_flops"]
    raise ValueError(f"no peak for dtype {dtype!r}")


def network_macs_per_row(obs_dim: int, layers, n_actions: int, use_rnn: bool) -> int:
    """Multiply-adds of one agent's network on one row. With `use_rnn`:
    Linear obs->H, then len(layers)-1 GRU layers (input and hidden
    projections, 3H wide each), then Linear H->actions. Without: the MLP
    obs->layers...->actions."""
    layers = [int(h) for h in layers]
    if use_rnn:
        H = layers[0]
        n_gru = len(layers) - 1
        return obs_dim * H + n_gru * 2 * H * 3 * H + H * n_actions
    dims = [obs_dim, *layers, n_actions]
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def mixer_macs_per_row(n_agents: int, state_dim: int, embed_dim: int, hypernet_layers: int,
                       hypernet_embed: int) -> int:
    """Multiply-adds of the QMIX mixer on one (t, b) row: the hypernetworks
    of w1, w_final and b1, the value head, and the two mixing products."""
    S, E, HE, N = state_dim, embed_dim, hypernet_embed, n_agents
    if hypernet_layers >= 2:
        hw1 = S * HE + HE * N * E
        hwf = S * HE + HE * E
    else:
        hw1 = S * N * E
        hwf = S * E
    return hw1 + hwf + S * E + (S * E + E) + (N * E + E)


def gru_kernel_flops(kernel: str, G: int, T: int, B: int, H: int) -> float:
    """Operations of one GRU kernel launch: 2*M*N*K for each product over
    K = T*B rows (the forward's h @ W_hh; the recurrence's h_prev @ W_hh and
    dgh @ W_hh^T; the weight gradient's h_prev^T dgh)."""
    products = {"fwd": 1, "bwd": 2, "dw": 1}[kernel]
    return float(products * 2 * G * T * B * H * 3 * H)


def gru_layer_bytes(direction: str, G: int, T: int, B: int, H: int) -> float:
    """f32 bytes one GRU layer call must move. Forward: gi, W_hh, b_hh, h0 ->
    y, hT. Backward (recurrence, weight gradient and reduction as one):
    gi, W_hh, b_hh, h0, y, dy, dhT -> dgi, dW_hh, db_hh, dh0."""
    H3, K = 3 * H, T * B
    weights = H * H3 + H3
    if direction == "fwd":
        elements = K * H3 + weights + B * H + K * H + B * H
    elif direction == "bwd":
        elements = (K * H3 + weights + B * H + 2 * K * H + B * H) + (K * H3 + weights + B * H)
    else:
        raise ValueError(f"unknown direction {direction!r}")
    return float(4 * G * elements)


def gru_bounds(direction: str, G: int, T: int, B: int, H: int, peaks: dict):
    """(least seconds, "operations" | "bytes") of one GRU layer call."""
    if direction == "fwd":
        ops = 3 * gru_kernel_flops("fwd", G, T, B, H)
    else:
        ops = 3 * (gru_kernel_flops("bwd", G, T, B, H) + gru_kernel_flops("dw", G, T, B, H))
    t_ops = ops / peaks["tf32_flops"]
    t_bytes = gru_layer_bytes(direction, G, T, B, H) / peaks["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")
