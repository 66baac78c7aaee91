"""Network specs: MLP and GRU/LSTM stacks as init/apply pairs over stacked params.

Each spec has `init(generator) -> params` (one network, weights `(in, out)`)
and `apply(params, x, h)`, where every parameter and input carries a leading
group axis G: the multi-agent container (`models/multi_agent.py`) runs all
agents' networks at once with batched matmuls, and the GRU recurrence runs
all of them in one kernel launch.

Initialisation matches the JAX package (and the reference):
- MLP: orthogonal init, gain sqrt(2), zero bias on every Linear when
  `use_orthogonal_init`, else torch's Linear default U(+-sqrt(1/fan_in)).
- RNN: first Linear and GRU/LSTM use torch defaults; only the final Linear
  is orthogonally initialised. GRU and LSTM weights use U(+-1/sqrt(hidden)).

`compute_dtype="bfloat16"` is the JAX package's mixed precision: every
matmul (MLP layers, the RNN's first and final layers, the GRU's input
projection, the per-step GRU and LSTM cells) takes bf16 inputs and gives an
f32 result (`ops/matmul.py`); biases, activations, the GRU kernels'
recurrence and everything downstream stay f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Tuple

import torch

from codebase_tpu_torch.ops.fused_gru import MAX_HIDDEN, gru_layer_sequence, kernel_variant
from codebase_tpu_torch.ops.matmul import grouped_matmul

DTYPES = ("float32", "bfloat16")

# ---------------------------------------------------------------------------
# Initialisers (one network; CPU tensors from a CPU generator)
# ---------------------------------------------------------------------------


def orthogonal(shape, gain: float, generator: torch.Generator):
    """Orthogonal init with torch.nn.init.orthogonal_ semantics."""
    n_rows, n_cols = shape[0], math.prod(shape[1:])
    a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return (gain * q[:n_rows, :n_cols]).reshape(shape).contiguous()


def _uniform(shape, bound: float, generator: torch.Generator):
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def linear_init(in_dim: int, out_dim: int, use_orthogonal: bool, generator: torch.Generator):
    """One Linear layer: {"w": (in, out), "b": (out,)}."""
    if use_orthogonal:
        # torch orthogonal_ works on (out, in); store (in, out)
        w = orthogonal((out_dim, in_dim), math.sqrt(2), generator).T.contiguous()
        return {"w": w, "b": torch.zeros(out_dim)}
    bound = math.sqrt(1.0 / in_dim)
    return {"w": _uniform((in_dim, out_dim), bound, generator), "b": _uniform((out_dim,), bound, generator)}


def lstm_layer_init(in_dim: int, hidden: int, generator: torch.Generator):
    """One LSTM layer, torch gate order [i, f, g, o] along the 4H axis:
    w_ih (in, 4H), w_hh (H, 4H), b_ih (4H,), b_hh (4H,)."""
    bound = math.sqrt(1.0 / hidden)
    return {
        "w_ih": _uniform((in_dim, 4 * hidden), bound, generator),
        "w_hh": _uniform((hidden, 4 * hidden), bound, generator),
        "b_ih": _uniform((4 * hidden,), bound, generator),
        "b_hh": _uniform((4 * hidden,), bound, generator),
    }


def gru_layer_init(in_dim: int, hidden: int, generator: torch.Generator):
    """One GRU layer, torch gate order [r, z, n] along the 3H axis:
    w_ih (in, 3H), w_hh (H, 3H), b_ih (3H,), b_hh (3H,)."""
    bound = math.sqrt(1.0 / hidden)
    return {
        "w_ih": _uniform((in_dim, 3 * hidden), bound, generator),
        "w_hh": _uniform((hidden, 3 * hidden), bound, generator),
        "b_ih": _uniform((3 * hidden,), bound, generator),
        "b_hh": _uniform((3 * hidden,), bound, generator),
    }


# ---------------------------------------------------------------------------
# Grouped tensor ops (leading group axis G on params and inputs)
# ---------------------------------------------------------------------------


def linear(x, w, b, compute_dtype="float32"):
    """x (G, ..., in), w (G, in, out), b (G, out) -> (G, ..., out)."""
    G = x.shape[0]
    y = grouped_matmul(x.reshape(G, -1, x.shape[-1]), w, compute_dtype).view(*x.shape[:-1], w.shape[-1])
    return y + b.view((G,) + (1,) * (x.ndim - 2) + (w.shape[-1],))


def gru_cell(params, x, h, compute_dtype="float32"):
    """One GRU step, torch gate convention. x (G, B, in), h (G, B, H)."""
    H = h.shape[-1]
    gi = linear(x, params["w_ih"], params["b_ih"], compute_dtype)
    gh = linear(h, params["w_hh"], params["b_hh"], compute_dtype)
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H : 2 * H] + gh[..., H : 2 * H])
    n = torch.tanh(gi[..., 2 * H :] + r * gh[..., 2 * H :])
    return (1.0 - z) * n + z * h


def lstm_cell(params, x, hc, compute_dtype="float32"):
    """One LSTM step, torch gate convention. x (G, B, in); hc (G, B, 2H) is
    h and c concatenated, so the carry is one tensor like the GRU's."""
    H = hc.shape[-1] // 2
    h, c = hc[..., :H], hc[..., H:]
    gates = linear(x, params["w_ih"], params["b_ih"], compute_dtype) + linear(
        h, params["w_hh"], params["b_hh"], compute_dtype)
    i = torch.sigmoid(gates[..., :H])
    f = torch.sigmoid(gates[..., H : 2 * H])
    g = torch.tanh(gates[..., 2 * H : 3 * H])
    o = torch.sigmoid(gates[..., 3 * H :])
    c_new = f * c + i * g
    return torch.cat([o * torch.tanh(c_new), c_new], dim=-1)


# ---------------------------------------------------------------------------
# Network specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLPSpec:
    """Fully-connected network: Linear(+ReLU) stack."""

    dims: Tuple[int, ...]  # (in, h1, ..., out)
    use_orthogonal_init: bool = True
    compute_dtype: str = "float32"

    def init(self, generator):
        return {
            "layers": [
                linear_init(self.dims[i], self.dims[i + 1], self.use_orthogonal_init, generator)
                for i in range(len(self.dims) - 1)
            ]
        }

    def apply(self, params, x, h=None):
        """x (G, ..., in) -> (G, ..., out); ReLU between layers."""
        n = len(params["layers"])
        for i, layer in enumerate(params["layers"]):
            x = linear(x, layer["w"], layer["b"], self.compute_dtype)
            if i < n - 1:
                x = torch.relu(x)
        return x, h

    @property
    def num_rnn_layers(self):
        return 0


@dataclass(frozen=True)
class RNNSpec:
    """Linear -> ReLU -> {GRU|LSTM} stack -> Linear over (T, B, feat).

    dims = (in, hidden, ..., hidden, out) with `len(dims) - 3` recurrent
    layers, all hidden sizes equal. Hidden state (G, L, B, C): C = H for the
    GRU, 2H (h and c concatenated) for the LSTM.

    `route`, decided from the cell, `fused_rnn` and the hidden size H when
    the spec is built, says how every recurrent layer runs, as the JAX
    package decides where its TPU kernel applies:

    | GRU, H | "auto" | "on" |
    |---|---|---|
    | H = 128 | "kernel_resident" | "kernel_resident" |
    | H % 128 == 0, 256 <= H <= 896 | "kernel_wide" | "kernel_wide" |
    | any other H | "cell" | ValueError |

    "off" and the LSTM (no kernel in either package; "on" with it raises)
    take "cell", the per-step recurrence, with `gh` from bf16 inputs under
    bf16 as the JAX package's scan. The kernel routes run the GRU kernels
    of `ops/fused_gru.py` on a CUDA tensor (they launch or raise) and their
    plain version on a CPU tensor, with `gh` in f32 at every dtype: the JAX
    package's `fused_rnn="on"` (its "interpret" on the CPU), not its "auto",
    which always scans.
    """

    dims: Tuple[int, ...]
    use_orthogonal_init: bool = True
    fused_rnn: str = "auto"
    cell: str = "gru"  # "gru" | "lstm"
    compute_dtype: str = "float32"
    route: str = field(init=False)

    def __post_init__(self):
        hiddens = self.dims[1:-1]
        if len(self.dims) < 4 or any(h != hiddens[0] for h in hiddens):
            raise ValueError(
                "RNN dims must be (in, H, ..., H, out) with at least two equal hidden sizes"
            )
        if self.cell == "lstm" and self.fused_rnn == "on":
            raise ValueError("fused_rnn=on requires the GRU cell")
        variant = kernel_variant(self.hidden_size) if self.cell == "gru" and self.fused_rnn != "off" else None
        if self.fused_rnn == "on" and variant is None:
            raise ValueError(
                f"fused_rnn=on needs a hidden size the GRU kernels take (H % 128 == 0, up to "
                f"{MAX_HIDDEN}); got {self.hidden_size}"
            )
        object.__setattr__(self, "route", f"kernel_{variant}" if variant else "cell")

    @property
    def hidden_size(self):
        return self.dims[1]

    @property
    def num_rnn_layers(self):
        return len(self.dims[1:-1]) - 1

    @property
    def carry_size(self):
        return self.hidden_size * (2 if self.cell == "lstm" else 1)

    def init(self, generator):
        H = self.hidden_size
        layer_init = lstm_layer_init if self.cell == "lstm" else gru_layer_init
        first = linear_init(self.dims[0], H, False, generator)
        rnn = [layer_init(H, H, generator) for _ in range(self.num_rnn_layers)]
        final = linear_init(H, self.dims[-1], self.use_orthogonal_init, generator)
        return {"first": first, "rnn": rnn, "final": final}

    def apply(self, params, x, h=None):
        """x (G, T, B, in), h (G, L, B, C) or None -> (y (G, T, B, out),
        h (G, L, B, C))."""
        G, T, B, _ = x.shape
        if h is None:
            h = self.init_hiddens(G, B, x.device)
        dtype = self.compute_dtype
        x = torch.relu(linear(x, params["first"]["w"], params["first"]["b"], dtype))
        H = self.hidden_size
        cell = lstm_cell if self.cell == "lstm" else gru_cell
        new_h = []
        for i, layer in enumerate(params["rnn"]):
            h0 = h[:, i].contiguous()
            if self.route == "cell":
                ys = []
                hl = h0
                for t in range(T):
                    hl = cell(layer, x[:, t], hl, dtype)
                    ys.append(hl[..., :H])  # the layer's output is h only
                x = torch.stack(ys, dim=1)
            else:
                x, hl = gru_layer_sequence(layer, x, h0, dtype)
            new_h.append(hl)
        y = linear(x, params["final"]["w"], params["final"]["b"], dtype)
        return y, torch.stack(new_h, dim=1)

    def init_hiddens(self, G: int, batch_size: int, device):
        return torch.zeros((G, self.num_rnn_layers, batch_size, self.carry_size), device=device)


def normalize_rnn_cell(use_rnn):
    """`use_rnn` config value -> "gru", "lstm" or None (MLP)."""
    if use_rnn is True:
        return "gru"
    if not use_rnn:
        return None
    cell = str(use_rnn).lower()
    if cell not in ("gru", "lstm"):
        raise ValueError(f"use_rnn must be bool, 'gru' or 'lstm'; got {use_rnn!r}")
    return cell


def normalize_fused_rnn(fused_rnn) -> str:
    """Accept the JAX package's values: "interpret" has no meaning here and
    behaves as "auto"; booleans map to on/off."""
    mode = str(fused_rnn).lower()
    mode = {"true": "on", "false": "off", "none": "off", "interpret": "auto"}.get(mode, mode)
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused_rnn must be auto/on/off/interpret; got {fused_rnn!r}")
    return mode


def make_network_spec(dims, use_rnn=False, use_orthogonal_init=True, compute_dtype="float32", fused_rnn="auto"):
    """`make_network` switch: an RNNSpec when `use_rnn`, else an MLPSpec."""
    if compute_dtype not in DTYPES:
        raise ValueError(f"unsupported model dtype {compute_dtype!r}; choose float32 or bfloat16")
    dims = tuple(int(d) for d in dims)
    cell = normalize_rnn_cell(use_rnn)
    if cell:
        return RNNSpec(dims, bool(use_orthogonal_init), normalize_fused_rnn(fused_rnn), cell, compute_dtype)
    return MLPSpec(dims, bool(use_orthogonal_init), compute_dtype)
