"""The port's MultiAgentNetwork against the JAX package's, on the same params
(made by the JAX `init`, carried across with `params_from_numpy`) and the
same numpy inputs. The JAX GRU runs its Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codebase_tpu.models.multi_agent import MultiAgentNetwork as JaxMultiAgentNetwork
from codebase_tpu_torch.models.multi_agent import MultiAgentNetwork, resolve_sharing
from codebase_tpu_torch.models.networks import make_network_spec
from codebase_tpu_torch.ops import fused_gru as fg
from codebase_tpu_torch.utils.params import params_from_numpy, params_to_numpy, tree_leaves

torch.set_num_threads(2)
N, T, B, D, A = 3, 5, 6, 7, 4
SHARING = {"independent": False, "shared": True, "selective": [0, 0, 1]}


def _pair(use_rnn, sharing, seed=0):
    kw = dict(
        input_sizes=[D] * N, hidden_dims=[128, 128], output_sizes=[A] * N,
        parameter_sharing=SHARING[sharing], use_rnn=use_rnn,
    )
    jnet = JaxMultiAgentNetwork.create(fused_rnn="interpret", **kw)
    jparams = jax.jit(jnet.init)(jax.random.PRNGKey(seed))
    net = MultiAgentNetwork(fused_rnn="auto", **kw)
    net.load_params(params_from_numpy(jax.device_get(jparams)))
    return jnet, jparams, net


@pytest.mark.parametrize("use_rnn", [False, True])
@pytest.mark.parametrize("sharing", list(SHARING))
def test_forward_matches_jax(use_rnn, sharing):
    jnet, jparams, net = _pair(use_rnn, sharing)
    assert net.n_groups == jnet.n_groups and net.sharing == jnet.sharing
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, T, B, D)).astype(np.float32)
    h = rng.standard_normal((N, 1, B, 128)).astype(np.float32) if use_rnn else None
    y_ref, h_ref = jax.jit(jnet.apply)(jparams, jnp.asarray(x), None if h is None else jnp.asarray(h))
    with torch.no_grad():
        y, hT = net(torch.tensor(x), None if h is None else torch.tensor(h))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
    if use_rnn:
        np.testing.assert_allclose(hT.numpy(), h_ref, rtol=1e-5, atol=1e-5)
    else:
        assert hT is None and h_ref is None


def test_selective_sharing_gradients_scatter_add_like_jax():
    """`per_agent_params` gathers (G, ...) -> (N, ...); the gradient must
    sum back into the shared group as JAX's `jnp.take` does."""
    jnet, jparams, net = _pair(False, "selective", seed=2)
    x = np.random.default_rng(3).standard_normal((N, T, B, D)).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jnet.apply(p, jnp.asarray(x))[0] ** 2)))(jparams)
    y, _ = net(torch.tensor(x))
    leaves = tree_leaves(net.param_tree())
    grads = torch.autograd.grad((y**2).sum(), leaves)
    for g, r in zip(grads, tree_leaves(jax.device_get(jgrads))):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-5)


def test_param_bridge_round_trip_and_layout():
    jnet, jparams, net = _pair(True, "independent")
    back = params_to_numpy(net.param_tree())
    assert set(back) == {"first", "rnn", "final"}
    assert back["rnn"][0]["w_hh"].shape == (N, 128, 3 * 128)  # (G, H, 3H), weights (in, out)
    for a, b in zip(tree_leaves(back), tree_leaves(jax.device_get(jparams))):
        np.testing.assert_array_equal(a, b)


def test_own_init_and_options():
    assert resolve_sharing([5, 5, 2], 3) == (0, 0, 1)
    net = MultiAgentNetwork([D] * N, [128, 128], [A] * N, parameter_sharing=True, use_rnn=True,
                            generator=torch.Generator().manual_seed(0))
    tree = net.param_tree()
    w = tree["final"]["w"][0]  # orthogonal, gain sqrt(2): columns orthogonal
    np.testing.assert_allclose((w.T @ w).detach().numpy(), 2 * np.eye(A), atol=1e-5)
    assert float(tree["rnn"][0]["w_hh"].detach().abs().max()) <= 1 / np.sqrt(128)
    assert make_network_spec((D, 128, 128, A), use_rnn=True, fused_rnn="interpret").fused_rnn == "auto"
    assert make_network_spec((D, 128, 128, A), use_rnn=True, fused_rnn=False).fused_rnn == "off"
    lstm = make_network_spec((D, 128, 128, A), use_rnn="lstm")
    assert (lstm.cell, lstm.carry_size) == ("lstm", 256)
    with pytest.raises(ValueError, match="GRU"):
        make_network_spec((D, 128, 128, A), use_rnn="lstm", fused_rnn="on")


def test_fused_off_is_the_same_recurrence():
    """"off" (per-step GRU cells) and "auto" (the layer sequence path) agree."""
    kw = dict(input_sizes=[D] * 2, hidden_dims=[128, 128], output_sizes=[A] * 2, use_rnn=True)
    on = MultiAgentNetwork(fused_rnn="on", **kw)
    off = MultiAgentNetwork(fused_rnn="off", **kw)
    off.load_params(on.param_tree())
    x = torch.tensor(np.random.default_rng(4).standard_normal((2, T, B, D)).astype(np.float32))
    with torch.no_grad():
        (y1, h1), (y2, h2) = on(x), off(x)
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h1, h2, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sharing", ["independent", "shared"])
def test_lstm_forward_and_gradients_match_jax(sharing):
    """The LSTM (torch gate order i, f, g, o; carry h and c concatenated,
    C = 2H) runs the plain per-step cell on both sides. Values at 1e-5,
    gradients at 2e-4."""
    kw = dict(input_sizes=[D] * N, hidden_dims=[128, 128, 128], output_sizes=[A] * N,
              parameter_sharing=SHARING[sharing], use_rnn="lstm")
    jnet = JaxMultiAgentNetwork.create(fused_rnn="auto", **kw)
    jparams = jax.jit(jnet.init)(jax.random.PRNGKey(4))
    net = MultiAgentNetwork(fused_rnn="auto", **kw)
    net.load_params(params_from_numpy(jax.device_get(jparams)))
    assert net.init_hiddens(B).shape == (N, 2, B, 256)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, T, B, D)).astype(np.float32)
    h = (rng.standard_normal((N, 2, B, 256)) * 0.5).astype(np.float32)
    w = rng.standard_normal((N, T, B, A)).astype(np.float32)

    def jloss(p, h):
        y, hT = jnet.apply(p, jnp.asarray(x), h)
        return jnp.sum(y * w) + jnp.sum(hT ** 2), (y, hT)

    (_, (y_ref, h_ref)), (gp_ref, gh_ref) = jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(h))
    th = torch.tensor(h, requires_grad=True)
    y, hT = net(torch.tensor(x), th)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hT.detach().numpy(), h_ref, rtol=1e-5, atol=1e-5)
    leaves = tree_leaves(net.param_tree())
    grads = torch.autograd.grad((y * torch.tensor(w)).sum() + (hT ** 2).sum(), leaves + [th])
    np.testing.assert_allclose(grads[-1].numpy(), gh_ref, rtol=2e-4, atol=1e-5)
    for g, r in zip(grads[:-1], tree_leaves(jax.device_get(gp_ref))):
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=1e-5)


def test_gru_route_follows_the_hidden_size_as_in_jax(monkeypatch):
    """Dispatch by hidden size, decided when the spec is built, as the JAX
    package decides where its TPU kernel applies: H=128 the resident-W_hh
    kernels, H % 128 == 0 up to 896 the wide kernels, any other H the
    per-step cell under "auto" and ValueError under "on". The kernel entry
    is stood in for by one that makes the CUDA wrappers' size check and
    then computes the plain version, so this CPU run goes where a CUDA
    tensor would."""
    calls = []

    def kernel_entry(gi, w_hh, b_hh, h0):
        calls.append(fg._dims(gi)[-1])
        return fg.gru_sequence_plain(gi, w_hh, b_hh, h0)

    monkeypatch.setattr(fg, "fused_gru_sequence", kernel_entry)
    x = torch.zeros((2, 2, 3, D))
    routes = {64: "cell", 128: "kernel_resident", 256: "kernel_wide", 512: "kernel_wide", 1024: "cell"}
    for hidden, route in routes.items():
        calls.clear()
        net = MultiAgentNetwork([D] * 2, [hidden, hidden], [A] * 2, use_rnn=True)
        with torch.no_grad():
            y, h = net(x)
        assert calls == ([] if route == "cell" else [hidden]), hidden
        assert net.spec.route == route and y.shape == (2, 2, 3, A) and h.shape == (2, 1, 3, hidden)
    assert make_network_spec((D, 256, 256, A), use_rnn=True, fused_rnn="on").route == "kernel_wide"
    assert make_network_spec((D, 256, 256, A), use_rnn=True, fused_rnn="off").route == "cell"
    assert make_network_spec((D, 256, 256, A), use_rnn="lstm").route == "cell"
    for hidden in (64, 1024):
        with pytest.raises(ValueError, match="fused_rnn=on needs a hidden size the GRU kernels take"):
            make_network_spec((D, hidden, hidden, A), use_rnn=True, fused_rnn="on")
