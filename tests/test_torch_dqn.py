"""The port's IDQN loss, gradients and optimizer steps against the JAX
package's, with the GRU critic, on the same params (JAX `init`, carried
across) and the same numpy batch. f32 on both sides; the JAX GRU runs its
Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codebase_tpu.algos.common import make_optimizer as jax_make_optimizer
from codebase_tpu.algos.dqn import DQNModel as JaxDQNModel
from codebase_tpu.config import Config as JaxConfig
from codebase_tpu.envs.lbforaging import parse_lbf_name as jax_parse_lbf_name
from codebase_tpu_torch.algos.common import Adam, hard_update
from codebase_tpu_torch.algos.dqn import DQNModel
from codebase_tpu_torch.config import Config
from codebase_tpu_torch.envs.lbforaging import parse_lbf_name
from codebase_tpu_torch.utils.params import params_from_numpy, tree_leaves

torch.set_num_threads(2)
ENV = "lbforaging:Foraging-8x8-2p-3f-v3"
N, T, B = 2, 5, 8
MODEL = dict(name="qnetwork", layers=[128, 128], parameter_sharing=False,
             use_orthogonal_init=True, use_rnn=True)
ALGO = dict(gamma=0.99, double_q=True, standardise_returns=False)


def _models():
    jmodel = JaxDQNModel.create(
        jax_parse_lbf_name(ENV), JaxConfig({**MODEL, "fused_rnn": "interpret"}), JaxConfig(ALGO)
    )
    model = DQNModel.create(parse_lbf_name(ENV), Config(MODEL), Config(ALGO))
    return jmodel, model


def _batch(seed, D=15, A=6):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, size=B)
    filled = (np.arange(T)[:, None] < lengths[None]).astype(np.float32)
    return dict(
        obss=rng.integers(-1, 8, size=(N, T + 1, B, D)).astype(np.float32),
        actions=rng.integers(0, A, size=(N, T, B)).astype(np.int32),
        rewards=(rng.random((N, T, B)) * (rng.random((N, T, B)) < 0.3)).astype(np.float32),
        dones=np.concatenate([np.zeros((1, B)), (np.arange(T)[:, None] == lengths[None] - 1)], 0).astype(np.float32),
        filled=filled,
        action_mask=None,
    )


def _torch_batch(b):
    out = {k: (torch.tensor(v) if v is not None else None) for k, v in b.items()}
    out["actions"] = out["actions"].long()
    return out


def _jax_batch(b):
    return {k: (jnp.asarray(v) if v is not None else None) for k, v in b.items()}


def _to_torch_model(model, jparams):
    model.critic.load_params(params_from_numpy(jax.device_get(jparams["critic"])))


def test_loss_and_grads_match_jax():
    jmodel, model = _models()
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(0))
    tparams = jax.jit(jmodel.init_params)(jax.random.PRNGKey(1))
    target = DQNModel.create(parse_lbf_name(ENV), Config(MODEL), Config(ALGO))
    _to_torch_model(model, params)
    _to_torch_model(target, tparams)
    batch = _batch(2)

    loss_fn = lambda p: jmodel.loss(p, tparams, _jax_batch(batch), jmodel.init_rms())[0]  # noqa: E731
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = model.loss(target, _torch_batch(batch))
    grads = torch.autograd.grad(loss, model.param_leaves())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4)
    for g, r in zip(grads, tree_leaves(jax.device_get(jgrads["critic"]))):
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("grad_clip", [0.05, 100.0])  # the clip fires / never fires
def test_three_optimizer_steps_match_optax(grad_clip):
    """Adam + global-norm clip + a hard target copy every 2 updates."""
    jmodel, model = _models()
    params = jax.jit(jmodel.init_params)(jax.random.PRNGKey(3))
    tparams = jax.tree.map(jnp.copy, params)
    _to_torch_model(model, params)
    target = DQNModel.create(parse_lbf_name(ENV), Config(MODEL), Config(ALGO))
    _to_torch_model(target, params)
    lr, interval = 1e-3, 2
    opt = jax_make_optimizer("adam", lr, grad_clip)
    opt_state = opt.init(params)
    topt = Adam(model.param_leaves(), lr, grad_clip)

    @jax.jit
    def jstep(params, tparams, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(jmodel.loss, has_aux=True)(
            params, tparams, batch, jmodel.init_rms()
        )
        upd, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    for u in range(1, 4):
        batch = _batch(10 + u)
        params, opt_state, jloss = jstep(params, tparams, opt_state, _jax_batch(batch))
        loss = model.loss(target, _torch_batch(batch))
        topt.step(torch.autograd.grad(loss, model.param_leaves()))
        if u % interval == 0:
            tparams = jax.tree.map(jnp.copy, params)
            hard_update(target.param_leaves(), model.param_leaves())
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-4, err_msg=f"loss {u}")
        # atol 5e-2 * lr: a gradient entry that cancels to ~1e-7 keeps only
        # its leading digits in f32, and Adam's g / (sqrt(v) + eps) turns
        # that into a step of up to lr in either package (a wrong Adam or
        # clip rule moves every entry by O(lr))
        for p, r in zip(model.param_leaves(), tree_leaves(jax.device_get(params["critic"]))):
            np.testing.assert_allclose(p.detach().numpy(), r, rtol=2e-4, atol=5e-2 * lr, err_msg=f"step {u}")
        for p, r in zip(target.param_leaves(), tree_leaves(jax.device_get(tparams["critic"]))):
            np.testing.assert_allclose(p.detach().numpy(), r, rtol=2e-4, atol=5e-2 * lr, err_msg=f"target {u}")


def test_adam_clip_is_optax_rule_not_clip_grad_norm():
    """optax scales by max_norm / norm; torch's clip_grad_norm_ by
    max_norm / (norm + 1e-6). At a norm of 1e-3 and max_norm 5e-4 the two
    differ by 0.1%."""
    g = [torch.full((4,), 5e-4)]  # norm 1e-3
    p = [torch.zeros(4)]
    opt = Adam(p, lr=1.0, grad_clip=5e-4)
    opt.step(g)
    jopt = jax_make_optimizer("adam", 1.0, 5e-4)
    jp = [jnp.zeros(4)]
    upd, _ = jopt.update([jnp.full((4,), 5e-4)], jopt.init(jp), jp)
    np.testing.assert_allclose(p[0].numpy(), np.asarray(upd[0]), rtol=1e-6)
    np.testing.assert_allclose(opt.mu[0].numpy(), 0.1 * 2.5e-4, rtol=1e-6)
