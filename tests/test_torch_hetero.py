"""Agents of unequal observation or action sizes (pad-to-max) in the port's
MultiAgentNetwork against the JAX package's: the JAX `init`'s padded
params carried across as they are, the same numpy inputs (zero beyond each
agent's own size), MLP and GRU(128), independent and selective sharing.
Outputs, gradients and `output_mask` equal JAX's (rtol 2e-4); the port's
own init pads each group's true-size network with zeros where JAX does, and
the padded rows and columns take zero gradients under a masked loss. The
JAX GRU runs its Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codebase_tpu.models.multi_agent import MultiAgentNetwork as JaxMultiAgentNetwork
from codebase_tpu_torch.models.multi_agent import MultiAgentNetwork
from codebase_tpu_torch.utils.params import params_from_numpy, tree_leaves

torch.set_num_threads(2)
T, B = 4, 5
INPUTS, OUTPUTS = [9, 9, 6], [5, 5, 4]  # agents 0 and 1 alike, agent 2 smaller
SHARING = {"independent": False, "selective": [0, 0, 1]}
RTOL, ATOL = 2e-4, 1e-6


def _pair(use_rnn, sharing, seed=0):
    kw = dict(input_sizes=INPUTS, hidden_dims=[128, 128], output_sizes=OUTPUTS,
              parameter_sharing=SHARING[sharing], use_rnn=use_rnn)
    jnet = JaxMultiAgentNetwork.create(fused_rnn="interpret", **kw)
    jparams = jax.jit(jnet.init)(jax.random.PRNGKey(seed))
    net = MultiAgentNetwork(fused_rnn="auto", **kw)
    net.load_params(params_from_numpy(jax.device_get(jparams)))
    return jnet, jparams, net


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(INPUTS), T, B, max(INPUTS))).astype(np.float32)
    for i, n in enumerate(INPUTS):
        x[i, ..., n:] = 0.0  # each agent's obs zero-padded beyond its own size
    return x


@pytest.mark.parametrize("use_rnn", [False, True])
@pytest.mark.parametrize("sharing", list(SHARING))
def test_outputs_gradients_and_mask_match_jax(use_rnn, sharing):
    jnet, jparams, net = _pair(use_rnn, sharing)
    np.testing.assert_array_equal(net.output_mask.numpy(), np.asarray(jnet.output_mask))
    x = _inputs(1)
    mask = np.asarray(jnet.output_mask)[:, None, None, :]

    def jloss(p):
        y, _ = jnet.apply(p, jnp.asarray(x))
        return jnp.sum((y * mask) ** 2), y

    (_, y_ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    y, _ = net(torch.tensor(x))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=RTOL, atol=ATOL)
    leaves = tree_leaves(net.param_tree())
    grads = torch.autograd.grad(((y * net.output_mask[:, None, None, :]) ** 2).sum(), leaves)
    for g, r in zip(grads, tree_leaves(jax.device_get(jgrads))):
        np.testing.assert_allclose(g.numpy(), r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_rnn", [False, True])
def test_own_init_pads_true_size_groups_with_zeros_and_padding_takes_no_gradient(use_rnn):
    """Each group initialised at its true dims: the padded input rows of the
    first layer and the padded output columns of the last are zero, where the
    JAX init has its zeros; under the masked loss they take zero gradients."""
    jnet, jparams, _ = _pair(use_rnn, "independent")
    net = MultiAgentNetwork(INPUTS, [128, 128], OUTPUTS, use_rnn=use_rnn,
                            generator=torch.Generator().manual_seed(0))
    first = "first" if use_rnn else "layers"
    tree, jtree = net.param_tree(), jax.device_get(jparams)
    w_in = tree[first]["w"] if use_rnn else tree[first][0]["w"]
    jw_in = jtree[first]["w"] if use_rnn else jtree[first][0]["w"]
    w_out = tree["final"]["w"] if use_rnn else tree[first][-1]["w"]
    jw_out = jtree["final"]["w"] if use_rnn else jtree[first][-1]["w"]
    for w, jw in ((w_in, jw_in), (w_out, jw_out)):
        np.testing.assert_array_equal(w.detach().numpy() == 0, np.asarray(jw) == 0)
    assert float(w_in.detach()[2, 6:].abs().max()) == 0 and float(w_out.detach()[2, :, 4:].abs().max()) == 0
    x = torch.tensor(_inputs(2))
    y, _ = net(x)
    g_in, g_out = torch.autograd.grad(((y * net.output_mask[:, None, None, :]) ** 2).sum(), [w_in, w_out])
    assert float(g_in[2, 6:].abs().max()) == 0 and float(g_out[2, :, 4:].abs().max()) == 0
    assert float(g_in[2, :6].abs().max()) > 0


def test_agents_sharing_a_network_need_equal_sizes():
    with pytest.raises(ValueError, match="agents sharing network 0 must have equal obs/action sizes"):
        MultiAgentNetwork(INPUTS, [64], OUTPUTS, parameter_sharing=True)
    with pytest.raises(AssertionError, match="must have equal obs/action sizes"):
        JaxMultiAgentNetwork.create(INPUTS, [64], OUTPUTS, parameter_sharing=True)
