"""Multi-agent network container: stacked per-group params, one batched pass.

The JAX package vmaps one network apply over a stacked agent axis. Here the
agent axis is written out: parameters are stacked along a leading group axis
(G groups: G=1 full sharing, G=N independent, or selective groups from a
list of sharing indices), `per_agent_params` gathers them to (N, ...) with
`index_select` (whose gradient scatter-adds back into the group stack), and
every layer is one batched matmul over the N agents; each GRU layer is one
kernel launch over (agents, batch tiles).

Agents must have equal observation and action sizes; the pad-to-max path
for heterogeneous agents waits for the environments that need it
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from codebase_tpu_torch.models.networks import make_network_spec
from codebase_tpu_torch.utils.params import load_tree, module_to_tree, tree_leaves, tree_map, tree_to_module


def resolve_sharing(sharing: Union[bool, Sequence[int]], n_agents: int) -> Tuple[int, ...]:
    """Normalise a sharing spec to per-agent group labels 0..G-1.

    True -> all agents share one network; False -> one network per agent;
    list -> agents with equal entries share. Labels are renumbered by first
    occurrence."""
    if sharing is True:
        raw = [0] * n_agents
    elif sharing is False or sharing is None:
        raw = list(range(n_agents))
    else:
        raw = list(sharing)
        if len(raw) != n_agents:
            raise ValueError("Expect same number of sharing indices as agents")
    remap = {}
    groups = []
    for label in raw:
        if label not in remap:
            remap[label] = len(remap)
        groups.append(remap[label])
    return tuple(groups)


class MultiAgentNetwork(nn.Module):
    """N agents' networks with parameter-sharing groups.

    Parameters live in `self.params` with the JAX package's tree layout and
    a leading group axis on every leaf (`param_tree()` returns the plain
    nested dict). `forward(inputs (N, T, B, D), hiddens (N, L, B, C))` ->
    (outputs (N, T, B, A), new hiddens or None)."""

    def __init__(
        self,
        input_sizes: Sequence[int],
        hidden_dims: Sequence[int],
        output_sizes: Sequence[int],
        parameter_sharing: Union[bool, Sequence[int]] = False,
        use_rnn=False,
        use_orthogonal_init: bool = True,
        fused_rnn: str = "auto",
        compute_dtype: str = "float32",
        generator: torch.Generator = None,
        device="cpu",
    ):
        super().__init__()
        n_agents = len(input_sizes)
        if len(output_sizes) != n_agents:
            raise ValueError("Expect same number of input and output sizes")
        if len(set(input_sizes)) != 1 or len(set(output_sizes)) != 1:
            raise NotImplementedError(
                "agents with different obs/action sizes are not ported yet (ROADMAP.md Queue 1)"
            )
        self.sharing = resolve_sharing(parameter_sharing, n_agents)
        self.n_agents = n_agents
        self.n_groups = max(self.sharing) + 1
        self.use_rnn = bool(use_rnn)
        dims = (int(input_sizes[0]),) + tuple(int(h) for h in hidden_dims) + (int(output_sizes[0]),)
        self.spec = make_network_spec(dims, use_rnn, use_orthogonal_init, compute_dtype, fused_rnn)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.params = tree_to_module(_stack([self.spec.init(generator) for _ in range(self.n_groups)]))
        self.register_buffer(
            "agent_to_group", torch.tensor(self.sharing, dtype=torch.long), persistent=False
        )
        self.to(device)

    def param_tree(self):
        """The parameters as a plain nested dict/list (leading axis G)."""
        return module_to_tree(self.params)

    def param_leaves(self):
        """The parameters in the JAX package's leaf order (`tree_leaves`)."""
        return tree_leaves(self.param_tree())

    def load_params(self, tree) -> None:
        """Copy a tree of tensors with this network's layout into it."""
        load_tree(self.param_tree(), tree)

    def per_agent_params(self):
        """Gather (G, ...) -> (N, ...); the gradient scatter-adds back."""
        idx = self.agent_to_group
        return tree_map(lambda p: p.index_select(0, idx), self.param_tree())

    def forward(self, inputs, hiddens=None):
        agent_params = self.per_agent_params()
        if self.use_rnn:
            if hiddens is None:
                hiddens = self.init_hiddens(inputs.shape[2])
            return self.spec.apply(agent_params, inputs, hiddens)
        outs, _ = self.spec.apply(agent_params, inputs)
        return outs, None

    def init_hiddens(self, batch_size: int):
        """Zero hidden state (N, L, B, C), or None for MLP networks (C = H for
        the GRU, 2H for the LSTM)."""
        if not self.use_rnn:
            return None
        return self.spec.init_hiddens(self.n_agents, batch_size, self.agent_to_group.device)


def _stack(trees):
    """Stack same-shaped trees along a new leading (group) axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)
