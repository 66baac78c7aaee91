"""Multi-agent network container: stacked per-group params, one batched pass.

The JAX package vmaps one network apply over a stacked agent axis. Here the
agent axis is written out: parameters are stacked along a leading group axis
(G groups: G=1 full sharing, G=N independent, or selective groups from a
list of sharing indices), `per_agent_params` gathers them to (N, ...) with
`index_select` (whose gradient scatter-adds back into the group stack), and
every layer is one batched matmul over the N agents; each GRU layer is one
kernel launch over (agents, batch tiles).

The units of a sweep fold into the same axis: given one generator per unit,
the network holds U*G stacked groups (unit u's are u*G .. u*G + G-1, each
unit's weights drawn from its own generator as a one-unit network draws
them) and runs U*N agent rows, `agent_to_group[u*N + a] = u*G + sharing[a]`.
Every layer, and every GRU kernel launch, then serves all units at once.

Agents of unequal observation or action sizes stack by pad-to-max, as in
the JAX package: each group's network is initialised at its true dims (the
init distributions depend on fan-in) and zero-padded to the largest input
and output sizes, so all groups stack into one tree and every layer (and
GRU launch, at the padded width) serves them all. Zero input padding keeps
the padded weight rows out of the forward pass and gives them zero
gradients; the padded output columns start at zero and stay there as long
as the caller never consumes outputs beyond an agent's own size:
`output_mask` is the (N, max_out) mask of the real ones. Agents that share
a network must have equal sizes. The parameters take the JAX package's
padded parameters as they are (`load_params`).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from codebase_tpu_torch.models.networks import make_network_spec
from codebase_tpu_torch.utils.params import load_tree, module_to_tree, stack_trees, tree_leaves, tree_map, tree_to_module


def _largest_shapes(trees):
    """A tree of the largest size of each leaf's every dimension over `trees`."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _largest_shapes([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_largest_shapes([t[i] for t in trees]) for i in range(len(first))]
    return torch.Size(max(d) for d in zip(*(t.shape for t in trees)))


def _pad_to(small, shapes):
    """The tree `small` with each leaf zero-padded at the end of each
    dimension to its shape in `shapes`."""
    if isinstance(small, dict):
        return {k: _pad_to(v, shapes[k]) for k, v in small.items()}
    if isinstance(small, (list, tuple)):
        return [_pad_to(v, b) for v, b in zip(small, shapes)]
    out = small.new_zeros(shapes)
    out[tuple(slice(0, n) for n in small.shape)] = small
    return out


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
    (outputs (N, T, B, A), new hiddens or None). `generator` may be a list
    of one generator per unit: the agent axis is then U*N and the group
    axis U*G, unit-major."""

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
        self.input_sizes = tuple(int(i) for i in input_sizes)
        self.output_sizes = tuple(int(o) for o in output_sizes)
        self.sharing = resolve_sharing(parameter_sharing, n_agents)
        self.n_agents = n_agents  # of one unit
        self.n_groups = max(self.sharing) + 1  # of one unit
        self.use_rnn = bool(use_rnn)
        hidden = tuple(int(h) for h in hidden_dims)

        def spec(n_in, n_out):
            return make_network_spec((n_in,) + hidden + (n_out,), use_rnn, use_orthogonal_init, compute_dtype,
                                     fused_rnn)

        # the reference asks for equal sizes only within a sharing group
        firsts = [self.sharing.index(g) for g in range(self.n_groups)]
        for g, first in enumerate(firsts):
            members = [i for i, s in enumerate(self.sharing) if s == g]
            if any((self.input_sizes[i], self.output_sizes[i]) != (self.input_sizes[first], self.output_sizes[first])
                   for i in members):
                raise ValueError(
                    f"agents sharing network {g} must have equal obs/action sizes (got inputs "
                    f"{[self.input_sizes[i] for i in members]}, outputs {[self.output_sizes[i] for i in members]})"
                )
        self.spec = spec(max(self.input_sizes), max(self.output_sizes))  # the padded, stacked network
        group_specs = [spec(self.input_sizes[f], self.output_sizes[f]) for f in firsts]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        generators = generator if isinstance(generator, (list, tuple)) else [generator]
        self.n_units = len(generators)
        # each group at its true dims, then zero-padded to the stacked
        # spec's shapes (the largest over the groups)
        trees = [s.init(g) for g in generators for s in group_specs]
        shapes = _largest_shapes(trees)
        trees = [_pad_to(t, shapes) for t in trees]
        self.params = tree_to_module(stack_trees(trees))
        groups = [u * self.n_groups + s for u in range(self.n_units) for s in self.sharing]
        self.register_buffer("agent_to_group", torch.tensor(groups, dtype=torch.long), persistent=False)
        self.to(device)

    @property
    def output_mask(self) -> torch.Tensor:
        """(U*N, max_out) float32: 1 where an output index is a real action
        of the agent, 0 where it is stack padding."""
        sizes = torch.tensor(self.output_sizes * self.n_units, device=self.agent_to_group.device)
        return (torch.arange(max(self.output_sizes), device=sizes.device)[None, :] < sizes[:, None]).float()

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
        """inputs (U*N, T, B, max_in), each agent's zero-padded beyond its
        own size -> (outputs (U*N, T, B, max_out), new hiddens or None); for
        agents of unequal sizes, mask the outputs with `output_mask`."""
        agent_params = self.per_agent_params()
        if self.use_rnn:
            if hiddens is None:
                hiddens = self.init_hiddens(inputs.shape[2])
            return self.spec.apply(agent_params, inputs, hiddens)
        outs, _ = self.spec.apply(agent_params, inputs)
        return outs, None

    def init_hiddens(self, batch_size: int):
        """Zero hidden state (U*N, L, B, C), or None for MLP networks (C = H
        for the GRU, 2H for the LSTM)."""
        if not self.use_rnn:
            return None
        return self.spec.init_hiddens(self.n_units * self.n_agents, batch_size, self.agent_to_group.device)

