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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from codebase_tpu_torch.models.networks import linear_init
from codebase_tpu_torch.utils.params import load_tree, module_to_tree, stack_trees, tree_to_module


def _linear(params, x):
    """x (..., in) or (U, K, in) with a unit axis on the params."""
    return x @ params["w"] + params["b"].unsqueeze(-2)


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

    @staticmethod
    def _hyper(layers, x):
        x = _linear(layers[0], x)
        if len(layers) == 2:
            x = _linear(layers[1], torch.relu(x))
        return x

    def forward(self, agent_qs, states):
        """agent_qs (N, T, B) per-agent chosen values, states (T, B, S) ->
        (T, B) mixed value; for U units agent_qs (U*N, T, B), states
        (U, T, B, S) -> (U, T, B)."""
        p = self.param_tree()
        U, N, E = self.n_units, self.n_agents, self.embed_dim
        lead = (U,) if U > 1 else ()
        T, B, S = states.shape[-3:]
        x = states.reshape(lead + (T * B, S))
        qs = agent_qs.reshape(U, N, T * B).transpose(1, 2).reshape(lead + (T * B, N))
        w1 = self._hyper(p["hyper_w_1"], x).abs().reshape(lead + (T * B, N, E))
        b1 = _linear(p["hyper_b_1"], x)  # (..., T*B, E)
        hidden = F.elu(torch.einsum("...kn,...kne->...ke", qs, w1) + b1)
        w_final = self._hyper(p["hyper_w_final"], x).abs()  # (..., T*B, E)
        v = _linear(p["v"][1], torch.relu(_linear(p["v"][0], x)))  # (..., T*B, 1)
        return (torch.einsum("...ke,...ke->...k", hidden, w_final) + v[..., 0]).reshape(lead + (T, B))
