"""The QMIX monotonic mixer (VDN's mixer is a plain sum in the loss).

A hypernetwork of the global state makes |w1| (N x embed) and |w_final|
(embed x 1), so Q_tot is monotone in each agent's utility; an ELU hidden
layer and a state-dependent V(s) bias, as the JAX package's `QMixer`. The
state is the concatenation of all agents' observations.

Parameters keep the JAX package's tree (`hyper_w_1`, `hyper_w_final`,
`hyper_b_1`, `v`, each Linear `{w (in, out), b}`) with no group axis, and
torch-default Linear init U(+-sqrt(1/fan_in)) from the caller's generator.
Given one generator per unit of a sweep, every leaf takes a leading unit
axis (unit u's weights drawn from its own generator, as a one-unit mixer
draws them) and the hypernetworks run as products batched over the units.

Every product runs on the port's grouped f32 path (`networks.linear`, so
`ops/matmul.grouped_matmul`: on the card the weight gradients go to
`ops/grouped_dw`'s split-K kernels), with the units (one without a sweep)
as the group axis. The four layers that read the state (`hyper_w_1[0]`,
`hyper_w_final[0]`, `hyper_b_1`, `v[0]`) run as ONE product of the state
with their weights side by side, formed at call time: the state, the
widest input by far (N * obs wide over T * B rows), is read once in the
forward and once in the weight gradient, and autograd splits the gradient
back onto the four leaves.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from codebase_tpu_torch.models.networks import linear, linear_init
from codebase_tpu_torch.utils.params import load_tree, module_to_tree, stack_trees, tree_to_module


def _grouped(leaf, n_units: int):
    """A leaf with its unit axis: as held for a sweep's units, else (1, ...)."""
    return leaf if n_units > 1 else leaf.unsqueeze(0)


class QMixer(nn.Module):
    def __init__(
        self,
        n_agents: int,
        state_dim: int,
        embed_dim: int = 64,
        hypernet_layers: int = 2,
        hypernet_embed: int = 32,
        generator: torch.Generator = None,
        device="cpu",
    ):
        super().__init__()
        if hypernet_layers not in (1, 2):
            raise ValueError("hypernet_layers must be 1 or 2")
        self.n_agents, self.embed_dim = int(n_agents), int(embed_dim)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        generators = generator if isinstance(generator, (list, tuple)) else [generator]
        self.n_units = len(generators)
        S, E, H, N = int(state_dim), self.embed_dim, int(hypernet_embed), self.n_agents

        def init(generator):
            def lin(i, o):
                return linear_init(i, o, False, generator)

            if hypernet_layers == 1:
                hyper_w_1, hyper_w_final = [lin(S, E * N)], [lin(S, E)]
            else:
                hyper_w_1, hyper_w_final = [lin(S, H), lin(H, E * N)], [lin(S, H), lin(H, E)]
            return {
                "hyper_w_1": hyper_w_1,
                "hyper_w_final": hyper_w_final,
                "hyper_b_1": lin(S, E),
                "v": [lin(S, E), lin(E, 1)],
            }

        trees = [init(g) for g in generators]
        self.params = tree_to_module(trees[0] if self.n_units == 1 else stack_trees(trees))
        self.to(device)

    def param_tree(self):
        return module_to_tree(self.params)

    def load_params(self, tree) -> None:
        load_tree(self.param_tree(), tree)

    def _linear(self, layer, x):
        """x (U, K, in) -> (U, K, out) through one Linear of the tree."""
        U = self.n_units
        return linear(x, _grouped(layer["w"], U), _grouped(layer["b"], U))

    def _hyper_rest(self, layers, x):
        """A hypernetwork past its first layer (already applied to the state)."""
        return self._linear(layers[1], torch.relu(x)) if len(layers) == 2 else x

    def forward(self, agent_qs, states):
        """agent_qs (N, T, B) per-agent chosen values, states (T, B, S) ->
        (T, B) mixed value; for U units agent_qs (U*N, T, B), states
        (U, T, B, S) -> (U, T, B)."""
        p = self.param_tree()
        U, N, E = self.n_units, self.n_agents, self.embed_dim
        T, B, S = states.shape[-3:]
        K = T * B
        x = states.reshape(U, K, S)
        qs = agent_qs.reshape(U, N, K).transpose(1, 2)  # (U, K, N)
        # the four layers that read the state, as one product
        first = (p["hyper_w_1"][0], p["hyper_w_final"][0], p["hyper_b_1"], p["v"][0])
        w = torch.cat([_grouped(layer["w"], U) for layer in first], -1)
        b = torch.cat([_grouped(layer["b"], U) for layer in first], -1)
        h_w1, h_wf, b1, h_v = linear(x, w, b).split([layer["w"].shape[-1] for layer in first], -1)
        w1 = self._hyper_rest(p["hyper_w_1"], h_w1).abs().reshape(U, K, N, E)
        hidden = F.elu(torch.einsum("ukn,ukne->uke", qs, w1) + b1)
        w_final = self._hyper_rest(p["hyper_w_final"], h_wf).abs()  # (U, K, E)
        v = self._linear(p["v"][1], torch.relu(h_v))  # (U, K, 1)
        q_tot = torch.einsum("uke,uke->uk", hidden, w_final) + v[..., 0]
        return q_tot.reshape((U, T, B) if U > 1 else (T, B))
