"""The QMIX monotonic mixer (VDN's mixer is a plain sum in the loss).

A hypernetwork of the global state makes |w1| (N x embed) and |w_final|
(embed x 1), so Q_tot is monotone in each agent's utility; an ELU hidden
layer and a state-dependent V(s) bias, as the JAX package's `QMixer`. The
state is the concatenation of all agents' observations.

Parameters keep the JAX package's tree (`hyper_w_1`, `hyper_w_final`,
`hyper_b_1`, `v`, each Linear `{w (in, out), b}`) with no group axis, and
torch-default Linear init U(+-sqrt(1/fan_in)) from the caller's generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from codebase_tpu_torch.models.networks import linear_init
from codebase_tpu_torch.utils.params import load_tree, module_to_tree, tree_to_module


def _linear(params, x):
    return x @ params["w"] + params["b"]


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
        S, E, H, N = int(state_dim), self.embed_dim, int(hypernet_embed), self.n_agents

        def lin(i, o):
            return linear_init(i, o, False, generator)

        if hypernet_layers == 1:
            hyper_w_1, hyper_w_final = [lin(S, E * N)], [lin(S, E)]
        else:
            hyper_w_1, hyper_w_final = [lin(S, H), lin(H, E * N)], [lin(S, H), lin(H, E)]
        tree = {
            "hyper_w_1": hyper_w_1,
            "hyper_w_final": hyper_w_final,
            "hyper_b_1": lin(S, E),
            "v": [lin(S, E), lin(E, 1)],
        }
        self.params = tree_to_module(tree)
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
        (T, B) mixed value."""
        p = self.param_tree()
        N, E = self.n_agents, self.embed_dim
        T, B, _ = states.shape
        qs = agent_qs.permute(1, 2, 0)  # (T, B, N)
        w1 = self._hyper(p["hyper_w_1"], states).abs().reshape(T, B, N, E)
        b1 = _linear(p["hyper_b_1"], states)  # (T, B, E)
        hidden = F.elu(torch.einsum("tbn,tbne->tbe", qs, w1) + b1)
        w_final = self._hyper(p["hyper_w_final"], states).abs()  # (T, B, E)
        v = _linear(p["v"][1], torch.relu(_linear(p["v"][0], states)))  # (T, B, 1)
        return torch.einsum("tbe,tbe->tb", hidden, w_final) + v[..., 0]
