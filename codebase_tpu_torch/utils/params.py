"""Weight bridge between the JAX package's parameter pytrees and the port.

Both sides keep the same layouts — weights `(in, out)`, GRU gates `[r, z, n]`
along the `3H` axis, a leading group axis `G` on every stacked leaf — so the
bridge is a copy, not a transpose. Trees are nested dicts and lists:
`critic.first.{w,b}`, `critic.rnn[i].{w_ih,w_hh,b_ih,b_hh}`,
`critic.final.{w,b}` for the recurrent net, `critic.layers[i].{w,b}` for the
MLP, and for QMIX `mixer.{hyper_w_1,hyper_w_final,v}[i].{w,b}` and
`mixer.hyper_b_1.{w,b}` (no group axis on the mixer).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_from_numpy(tree, device="cpu", dtype=torch.float32):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return torch.as_tensor(np.array(tree), dtype=dtype).to(device).contiguous()


def params_to_numpy(tree):
    """Tree of tensors -> the same tree of numpy arrays (on the host)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def tree_leaves(tree) -> list:
    """Leaves in a fixed order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@torch.no_grad()
def load_tree(dst, src) -> None:
    """Copy the leaves of tree `src` into the same-shaped tree `dst`."""
    dst, src = tree_leaves(dst), tree_leaves(src)
    if len(dst) != len(src):
        raise ValueError(f"param tree has {len(src)} leaves; expected {len(dst)}")
    for d, s in zip(dst, src):
        if d.shape != s.shape:
            raise ValueError(f"param shape {tuple(s.shape)}; expected {tuple(d.shape)}")
        d.copy_(s)


def tree_to_module(tree):
    """A tree of tensors -> nested ParameterDict/ModuleDict/ModuleList, so
    the leaves are the module's parameters."""
    if isinstance(tree, dict):
        if all(isinstance(v, torch.Tensor) for v in tree.values()):
            return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})
        return nn.ModuleDict({k: tree_to_module(v) for k, v in tree.items()})
    return nn.ModuleList([tree_to_module(v) for v in tree])


def module_to_tree(module):
    """The inverse of `tree_to_module`: a plain nested dict/list of the
    module's parameters."""
    if isinstance(module, nn.ParameterDict):
        return {k: v for k, v in module.items()}
    if isinstance(module, nn.ModuleDict):
        return {k: module_to_tree(v) for k, v in module.items()}
    return [module_to_tree(v) for v in module]
