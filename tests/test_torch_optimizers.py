"""The port's rmsprop, sgd and adamw (`algos/common.py`) against optax as the
JAX package builds them (`codebase_tpu/algos/common.py` `make_optimizer`):
three steps on the same numpy gradients, with and without the global-norm
clip (whole-tree and masked to the critic), in float32 (rtol 1e-6) and
float64 (rtol 1e-12); four sweep units against `jax.vmap` over optax; and a
checkpoint that the JAX package wrote under `algorithm.optimizer=rmsprop`,
loaded into the port and continued on the same batches as the JAX package
continues it (rtol 2e-4, the IDQN tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codebase_tpu import run as jax_run
from codebase_tpu.algos.common import make_optimizer as jax_make_optimizer
from codebase_tpu.utils.checkpoint import latest_checkpoint, load_checkpoint as jax_load_checkpoint
from codebase_tpu_torch.algos.common import SGD, Adam, AdamW, RMSProp, make_optimizer
from codebase_tpu_torch.utils import checkpoint as ckpt
from codebase_tpu_torch.utils.params import tree_leaves

from tests.test_torch_dqn import ENV, _batch, _jax_batch, _models, _torch_batch

torch.set_num_threads(2)
SHAPES = {"critic": {"w": (5, 3), "b": (3,)}, "mixer": {"v": (4,)}}
# the clip fires at steps 1-3 at 0.5 on these gradients, and never at 100
CLIPS = {"none": False, "fires": 0.5, "never": 100.0}


def _tree(rng, dtype, scale=1.0):
    return {part: {k: (scale * rng.standard_normal(s)).astype(dtype) for k, s in leaves.items()}
            for part, leaves in SHAPES.items()}


def _leaves(tree):
    """The tree's leaves in `tree_leaves` order (sorted keys), as numpy."""
    return [np.asarray(x) for x in tree_leaves(jax.device_get(tree))]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("clip", ["none", "fires", "never", "masked"])
@pytest.mark.parametrize("name", ["adam", "rmsprop", "sgd", "adamw"])
def test_three_steps_match_optax(name, clip, dtype):
    rtol, atol = (1e-6, 1e-7) if dtype == np.float32 else (1e-12, 1e-14)
    rng = np.random.default_rng(0)
    params = _tree(rng, dtype)
    grads = [_tree(rng, dtype, 0.3) for _ in range(3)]
    lr = 1e-2
    grad_clip = CLIPS["fires"] if clip == "masked" else CLIPS[clip]
    mask = {"critic": True, "mixer": False} if clip == "masked" else None
    with jax.enable_x64(dtype == np.float64):
        jopt = jax_make_optimizer(name, lr, grad_clip, clip_mask=mask)
        jparams = jax.tree.map(jnp.asarray, params)
        jstate = jopt.init(jparams)
        port = [torch.tensor(x) for x in _leaves(params)]
        clip_mask = [True, True, False] if clip == "masked" else None
        opt = make_optimizer(name, port, lr, grad_clip, clip_mask=clip_mask)
        assert type(opt) is {"adam": Adam, "rmsprop": RMSProp, "sgd": SGD, "adamw": AdamW}[name]
        for step, g in enumerate(grads, 1):
            upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
            jparams = optax.apply_updates(jparams, upd)
            opt.step([torch.tensor(x) for x in _leaves(g)])
            for p, r in zip(port, _leaves(jparams)):
                np.testing.assert_allclose(p.numpy(), r, rtol=rtol, atol=atol, err_msg=f"{name} step {step}")
        # the state dict is flax's of the optax state, leaf for leaf
        assert _same_layout(opt.state_dict({"critic": {"b": 0, "w": 0}, "mixer": {"v": 0}}),
                            jax.device_get(_to_state_dict(jstate)), rtol, atol)


def _to_state_dict(state):
    from flax import serialization

    return serialization.to_state_dict(state)


def _same_layout(port, ref, rtol, atol) -> bool:
    assert isinstance(port, dict) == isinstance(ref, dict), (port, ref)
    if isinstance(ref, dict):
        assert set(port) == set(ref), (sorted(port), sorted(ref))
        return all(_same_layout(port[k], ref[k], rtol, atol) for k in ref)
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)
    return True


@pytest.mark.parametrize("name", ["rmsprop", "sgd", "adamw"])
def test_four_units_match_vmapped_optax(name):
    """n_units=4: per-unit lr, per-unit clip norm (the clip fires for some
    units only), and an inactive unit at step 2 that keeps its params and
    moments, as `jax.vmap` over optax with a `where` on the step gives."""
    U, lr = 4, np.array([1e-2, 3e-3, 2e-2, 5e-3])
    rng = np.random.default_rng(1)
    params = [_tree(rng, np.float32) for _ in range(U)]
    grads = [[_tree(rng, np.float32, s) for s in (0.05, 0.3, 1.0, 0.1)] for _ in range(3)]
    active = [np.ones(U, bool), np.array([True, False, True, True]), np.ones(U, bool)]

    def stack(trees):
        return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)

    def jopt(lr_u):
        return jax_make_optimizer(name, lr_u, 0.5)

    jparams = stack(params)
    jstates = jax.vmap(lambda p, l: jopt(l).init(p))(jparams, jnp.asarray(lr, jnp.float32))

    @jax.jit
    def jstep(p, s, g, l, a):
        def one(p, s, g, l, a):
            upd, new_s = jopt(l).update(g, s, p)
            new_p = optax.apply_updates(p, upd)
            keep = lambda new, old: jnp.where(a, new, old)  # noqa: E731
            return jax.tree.map(keep, new_p, p), jax.tree.map(keep, new_s, s)

        return jax.vmap(one)(p, s, g, l, a)

    port = [torch.tensor(np.stack(x)) for x in zip(*[_leaves(p) for p in params])]
    opt = make_optimizer(name, port, lr, 0.5, n_units=U)
    for step in range(3):
        jparams, jstates = jstep(jparams, jstates, stack(grads[step]), jnp.asarray(lr, jnp.float32),
                                 jnp.asarray(active[step]))
        opt.step([torch.tensor(np.stack(x)) for x in zip(*[_leaves(g) for g in grads[step]])], active[step])
        for p, r in zip(port, _leaves(jparams)):
            np.testing.assert_allclose(p.numpy(), r, rtol=1e-6, atol=1e-7, err_msg=f"{name} step {step}")
    assert list(opt.count) == [3, 2, 3, 3]


def test_unknown_optimizer_raises_like_jax():
    with pytest.raises(ValueError, match="unknown optimizer"):
        jax_make_optimizer("lamb", 1e-3)
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        make_optimizer("lamb", [torch.zeros(2)], 1e-3)


def test_jax_rmsprop_checkpoint_loads_and_continues_like_jax(tmp_path):
    """A JAX IDQN run with `algorithm.optimizer=rmsprop` and the clip writes
    a checkpoint; its params, target params and optimizer state load into the
    port's train state (`Optimizer.load_state_dict` reads the JAX
    chain's layout), and three more steps on the same batches give the JAX
    package's params (rtol 2e-4)."""
    from codebase_tpu.config import load_config as jax_load_config
    from codebase_tpu.envs.factory import make_env as jax_make_env
    from codebase_tpu.algos.dqn import build_train_functions as jax_build
    from codebase_tpu_torch.algos import dqn
    from codebase_tpu_torch.config import load_config
    from codebase_tpu_torch.envs.factory import make_env

    argv = ["+algorithm=idqn", f"env.name={ENV}", "env.time_limit=5", "env.parallel_envs=4",
            "algorithm.model.use_rnn=true", "algorithm.model.fused_rnn=interpret", "algorithm.total_steps=60",
            "algorithm.training_start=0", "algorithm.batch_size=2", "algorithm.buffer_size=8",
            "algorithm.eval_interval=1000", "algorithm.optimizer=rmsprop", "algorithm.save_interval=40", "seed=1"]
    jax_run.main(argv + [f"run_dir={tmp_path}"])
    raw = jax_load_checkpoint(latest_checkpoint(tmp_path / "checkpoints"))
    assert set(raw["opt_state"]) == {"0", "1"} and set(raw["opt_state"]["1"]["0"]) == {"nu"}

    # the JAX side: its own train state restored from the file
    jcfg = jax_load_config(argv)
    jcfg.algorithm.parallel_envs = 4
    jenv = jax_make_env(ENV, time_limit=5)
    _, jinit, _, _ = jax_build(jenv, jenv, jcfg.algorithm, 5)
    jstate = jax_load_checkpoint(latest_checkpoint(tmp_path / "checkpoints"), template=jinit(jax.random.PRNGKey(0)))
    jmodel, _ = _models()
    opt = jax_make_optimizer("rmsprop", float(jcfg.algorithm.lr), jcfg.algorithm.grad_clip)

    @jax.jit
    def jstep(params, tparams, opt_state, batch):
        grads = jax.grad(lambda p: jmodel.loss(p, tparams, batch, jmodel.init_rms())[0])(params)
        upd, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state

    # the port: a train state of the same config, the file's state loaded
    cfg = load_config(argv[:-1] + ["device=cpu"])
    cfg.algorithm.parallel_envs = 4
    env = make_env(ENV, time_limit=5)
    init_state, _, _ = dqn.build_train_functions(env, env, cfg.algorithm, 5, torch.device("cpu"))
    state = init_state(1)
    ckpt.load_params_state_dict(state.model.param_tree(), raw["params"])
    ckpt.load_params_state_dict(state.target.param_tree(), raw["target_params"])
    state.opt.load_state_dict(state.model.param_tree(), raw["opt_state"])
    assert isinstance(state.opt, RMSProp) and state.opt.grad_clip == float(jcfg.algorithm.grad_clip)

    params, tparams, opt_state = jstate.params, jstate.target_params, jstate.opt_state
    for u in range(3):
        batch = _batch(40 + u)
        params, opt_state = jstep(params, tparams, opt_state, _jax_batch(batch))
        loss, _ = state.model.loss(state.target, _torch_batch(batch), state.model.init_rms())
        state.opt.step(torch.autograd.grad(loss, state.model.param_leaves()))
        for p, r in zip(state.model.param_leaves(), _leaves(params["critic"])):
            np.testing.assert_allclose(p.detach().numpy(), r, rtol=2e-4, atol=1e-6, err_msg=f"step {u}")
    # and the port writes the optimizer back in the file's layout
    assert _same_layout(state.opt.state_dict(state.model.param_tree()),
                        jax.device_get(_to_state_dict(opt_state)), 2e-4, 1e-6)
