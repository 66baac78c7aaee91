"""Weight bridge between the JAX package's parameter pytrees and the port.

Both sides keep the same layouts — weights `(in, out)`, GRU gates `[r, z, n]`
along the `3H` axis, a leading group axis `G` on every stacked leaf — so the
bridge is a copy, not a transpose. Trees are nested dicts and lists:
`critic.first.{w,b}`, `critic.rnn[i].{w_ih,w_hh,b_ih,b_hh}`,
`critic.final.{w,b}` for the recurrent net, `critic.layers[i].{w,b}` for the
MLP.
"""

from __future__ import annotations

import numpy as np
import torch


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
