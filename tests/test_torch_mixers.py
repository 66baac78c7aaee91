"""The port's QMIX mixer against the JAX package's, on the same params (made
by the JAX `init`, carried across) and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codebase_tpu.models.mixers import QMixer as JaxQMixer
from codebase_tpu_torch.models.mixers import QMixer
from codebase_tpu_torch.utils.params import params_from_numpy, params_to_numpy, tree_leaves

torch.set_num_threads(2)
N, T, B, S = 3, 5, 8, 45


def _pair(hypernet_layers, seed=0):
    kw = dict(n_agents=N, state_dim=S, embed_dim=16, hypernet_layers=hypernet_layers, hypernet_embed=8)
    jmixer = JaxQMixer(**kw)
    jparams = jax.device_get(jmixer.init(jax.random.PRNGKey(seed)))
    mixer = QMixer(**kw)
    mixer.load_params(params_from_numpy(jparams))
    return jmixer, jparams, mixer


@pytest.mark.parametrize("hypernet_layers", [1, 2])
def test_mixer_values_and_gradients_match_jax(hypernet_layers):
    jmixer, jparams, mixer = _pair(hypernet_layers)
    rng = np.random.default_rng(1)
    qs = rng.standard_normal((N, T, B)).astype(np.float32)
    states = rng.integers(-1, 8, size=(T, B, S)).astype(np.float32)
    w = rng.standard_normal((T, B)).astype(np.float32)

    def jloss(p, q):
        return jnp.sum(jmixer.apply(p, q, jnp.asarray(states)) * w)

    y_ref = jmixer.apply(jparams, jnp.asarray(qs), jnp.asarray(states))
    (gp_ref, gq_ref) = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(qs))
    tq = torch.tensor(qs, requires_grad=True)
    y = mixer(tq, torch.tensor(states))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-5, atol=1e-5)
    leaves = tree_leaves(mixer.param_tree())
    grads = torch.autograd.grad((y * torch.tensor(w)).sum(), leaves + [tq])
    np.testing.assert_allclose(grads[-1].numpy(), gq_ref, rtol=2e-4, atol=1e-5)
    for g, r in zip(grads[:-1], tree_leaves(jax.device_get(gp_ref))):
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=1e-5)


def test_mixer_layout_init_and_options():
    _, jparams, mixer = _pair(2, seed=3)
    back = params_to_numpy(mixer.param_tree())
    assert set(back) == {"hyper_w_1", "hyper_w_final", "hyper_b_1", "v"}
    assert back["hyper_w_1"][1]["w"].shape == (8, 16 * N)  # (in, out), no group axis
    for a, b in zip(tree_leaves(back), tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    own = params_to_numpy(QMixer(N, S, 16, 2, 8, generator=torch.Generator().manual_seed(0)).param_tree())
    assert [t.shape for t in tree_leaves(own)] == [np.shape(t) for t in tree_leaves(jparams)]
    # torch-default Linear init: U(+-sqrt(1/fan_in)) on weight and bias
    assert np.abs(own["hyper_w_1"][0]["w"]).max() <= 1 / np.sqrt(S)
    assert np.abs(own["v"][1]["b"]).max() <= 1 / np.sqrt(16)
    with pytest.raises(ValueError, match="hypernet_layers"):
        QMixer(N, S, 16, 3, 8)
