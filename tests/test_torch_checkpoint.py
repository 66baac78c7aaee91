"""The port's checkpoints against the JAX package's: the msgpack codec
writes flax's bytes and reads them back; the checkpoint rules of
`tests/test_infra.py` (latest discovery, structure mismatch, pickle and bad
versions refused, template-free load, bf16 bit-exact); exact resume, on the
CPU, for IDQN, recurrent QMIX with reward standardisation, QMIX on
SMAClite 3m (masks in the replay) and recurrent MAPPO, through the train
functions and through the host loop's `save_interval` and `resume`; and
each package's eval reading the other's checkpoint `params` to the same
Q-values or logits (rtol 2e-4, the IDQN tolerance of ROADMAP.md)."""

import pickle

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from codebase_tpu import eval as jax_eval
from codebase_tpu import run as jax_run
from codebase_tpu.config import Config as JaxConfig
from codebase_tpu.envs.factory import make_env as jax_make_env
from codebase_tpu.utils import checkpoint as jax_checkpoint
from codebase_tpu_torch import eval as port_eval
from codebase_tpu_torch import run
from codebase_tpu_torch.algos import ac, dqn
from codebase_tpu_torch.config import Config, load_config
from codebase_tpu_torch.utils import msgpack
from codebase_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint

torch.set_num_threads(2)
CPU = torch.device("cpu")


# ------------------------------------------------------------------- codec


def _codec_trees(seed=0):
    """The same tree for the port (torch leaves, bf16 as torch.bfloat16)
    and for flax (numpy leaves, bf16 as ml_dtypes.bfloat16)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 17)).astype(np.float32)
    obs = rng.integers(-1, 9, size=(4, 6, 2, 15)).astype(np.float32)
    port = {
        "meta": {"version": 1, "format": "codebase_tpu-checkpoint"},
        "state": {
            "params": {"critic": {"rnn": {"0": {"w_hh": torch.from_numpy(w)}, "1": {"b": np.zeros(384, np.float32)}}}},
            "buffer": {"obs": torch.from_numpy(obs).to(torch.bfloat16), "pos": np.asarray(7, np.int32),
                       "action_mask": None, "flags": np.array([True, False, True])},
            "generator": torch.arange(300, dtype=torch.uint8), "generator_device": "cpu",
            "env_steps": np.asarray(123456, np.int32), "reward_stream": None,
            "ints": {"neg": -40, "big": 2**40, "f": 1.5, "text": "x" * 40, "yes": True},
        },
    }
    flax_tree = {
        "meta": dict(port["meta"]),
        "state": {
            **port["state"],
            "params": {"critic": {"rnn": {"0": {"w_hh": w}, "1": {"b": np.zeros(384, np.float32)}}}},
            "buffer": {**port["state"]["buffer"], "obs": obs.astype(ml_dtypes.bfloat16)},
            "generator": np.arange(300, dtype=np.uint8),
        },
    }
    return port, flax_tree


def _assert_trees_equal(got, ref):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == sorted(ref), (list(got), sorted(ref))
        for k in ref:
            _assert_trees_equal(got[k], ref[k])
    elif isinstance(ref, np.ndarray):
        if ref.dtype == ml_dtypes.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(np.int16))
        else:
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref and type(got) is type(ref)


def test_codec_writes_and_reads_flax_bytes():
    port, flax_tree = _codec_trees()
    blob = serialization.msgpack_serialize(flax_tree)
    assert msgpack.serialize(port) == blob
    _assert_trees_equal(msgpack.deserialize(blob), flax_tree)
    # a numpy scalar is flax's ext type 3, read back as a scalar
    scalar = {"s": np.float32(2.5)}
    assert msgpack.serialize(scalar) == serialization.msgpack_serialize(scalar)
    assert msgpack.deserialize(serialization.msgpack_serialize(scalar))["s"] == np.float32(2.5)


def test_codec_chunks_large_arrays_as_flax_does(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 1000)
    port, flax_tree = _codec_trees(1)  # obs: 720 bf16 words, 1440 bytes; w_hh 204 bytes
    blob = serialization.msgpack_serialize(flax_tree)
    assert b"__msgpack_chunked_array__" in blob
    assert msgpack.serialize(port) == blob
    _assert_trees_equal(msgpack.deserialize(blob), flax_tree)
    back = serialization.msgpack_restore(msgpack.serialize(port))
    np.testing.assert_array_equal(back["state"]["buffer"]["obs"].view(np.int16),
                                  flax_tree["state"]["buffer"]["obs"].view(np.int16))


def test_train_state_writes_flax_bytes_and_the_jax_schema(tmp_path):
    """A whole recurrent QMIX state (bf16 replay, mixer, reward streams):
    the file is flax's msgpack of the same tree, which the JAX package's
    loader reads."""
    cfg, env = _setup(CASES["qmix_lbf_std"])
    init_state, train_iteration, _ = dqn.build_train_functions(env, env, cfg.algorithm, int(cfg.env.time_limit), CPU)
    state = init_state(0)
    train_iteration(state)
    path = tmp_path / "model_s1.msgpack"
    save_checkpoint(path, state.state_dict())

    def to_flax(x):
        if isinstance(x, dict):
            return {k: to_flax(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            return x.numpy()
        return x

    payload = {"meta": {"format": "codebase_tpu-checkpoint", "version": 1}, "state": to_flax(state.state_dict())}
    assert path.read_bytes() == serialization.msgpack_serialize(payload)
    raw = jax_checkpoint.load_checkpoint(path)
    assert raw["buffer"]["obs"].dtype == jnp.bfloat16 and raw["buffer"]["actions"].dtype == np.int32
    assert raw["env_steps"].shape == () and raw["env_steps"].dtype == np.int32
    # flax's state dict of optax.chain(masked clip, adam), the JAX run's layout
    assert raw["opt_state"]["0"] == {"inner_state": {}} and set(raw["opt_state"]["1"]) == {"0", "1"}
    assert set(raw["opt_state"]["1"]["0"]) == {"count", "mu", "nu"} and set(raw["params"]) == {"critic", "mixer"}
    assert raw["params"]["critic"]["rnn"]["0"]["w_hh"].shape == (2, 128, 384)


# ------------------------------------- the rules of tests/test_infra.py:89-162


def test_latest_checkpoint_discovery(tmp_path):
    d = tmp_path / "checkpoints"
    for s in (100, 2000, 900):
        save_checkpoint(d / f"model_s{s}.msgpack", {"x": np.ones(3)})
    (d / "model_s5000.msgpack.tmp").write_bytes(b"torn")
    assert latest_checkpoint(d).name == "model_s2000.msgpack"
    with pytest.raises(FileNotFoundError):
        latest_checkpoint(tmp_path / "empty")


def test_structure_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path / "c.msgpack", {"a": np.ones(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(tmp_path / "c.msgpack", template={"b": {"c": np.ones(2)}})
    with pytest.raises(ValueError, match="shape, dtype"):
        load_checkpoint(tmp_path / "c.msgpack", template={"a": torch.ones(3)})


def test_old_pickle_format_rejected(tmp_path):
    p = tmp_path / "model_s5.pkl"
    p.write_bytes(pickle.dumps({"a": np.ones(2)}))
    with pytest.raises(ValueError, match="pickle"):
        load_checkpoint(p)


def test_bad_version_rejected(tmp_path):
    p = tmp_path / "model_s5.msgpack"
    p.write_bytes(serialization.msgpack_serialize(
        {"meta": {"format": "codebase_tpu-checkpoint", "version": 999}, "state": {}}))
    with pytest.raises(ValueError, match="schema"):
        load_checkpoint(p)
    p.write_bytes(serialization.msgpack_serialize({"meta": {"format": "other"}, "state": {}}))
    with pytest.raises(ValueError, match="schema"):
        load_checkpoint(p)


def test_templateless_load_returns_state_dict(tmp_path):
    p = tmp_path / "model_s7.msgpack"
    save_checkpoint(p, {"params": {"w": np.arange(4.0)}})
    np.testing.assert_array_equal(load_checkpoint(p)["params"]["w"], np.arange(4.0))


def test_bfloat16_replay_roundtrip_is_bit_exact(tmp_path):
    x = torch.randn(64, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    p = tmp_path / "model_s9.msgpack"
    save_checkpoint(p, {"x": x})
    back = load_checkpoint(p, template={"x": x})["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back.view(torch.int16), x.view(torch.int16))


# -------------------------------------------------------------- exact resume

# (overrides, E); the first mirrors tests/test_infra.py:95-101
CASES = {
    "idqn_matrix": (["+algorithm=idqn", "algorithm.training_start=0", "algorithm.buffer_size=64",
                     "algorithm.batch_size=8", "env.name=matrix-coordination", "env.time_limit=1"], 8),
    "qmix_lbf_std": (["+algorithm=qmix", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
                      "env.standardise_rewards=true", "algorithm.model.use_rnn=true", "algorithm.training_start=0",
                      "algorithm.batch_size=2", "algorithm.buffer_size=8", "algorithm.updates_per_collect=2"], 4),
    "qmix_smaclite_3m": (["+algorithm=qmix", "env.name=smaclite:3m-v0", "env.time_limit=8",
                          "algorithm.training_start=0", "algorithm.batch_size=2", "algorithm.buffer_size=8",
                          "algorithm.updates_per_collect=2"], 4),
    "mappo_rnn": (["+algorithm=mappo", "env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5",
                   "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true"], 4),
}


def _setup(case):
    argv, E = case
    cfg = load_config(argv + [f"env.parallel_envs={E}", "device=cpu"])
    cfg.algorithm.parallel_envs = E
    env, _ = run.build_envs(cfg)
    return cfg, env


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def assert_states_equal(a, b):
    """Every leaf of two state dicts equal: params, target, Adam moments,
    replay with `pos`, moments, counters and the generator state."""
    fa, fb = _flat(a.state_dict()), _flat(b.state_dict())
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, (torch.Tensor, np.ndarray)):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), k
        else:
            assert x == y, k


def _same(x, y):
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    return torch.equal(x, y) or bool(torch.isnan(x).all() and torch.isnan(y).all())


@pytest.mark.parametrize("name", list(CASES))
def test_resumed_state_continues_bit_for_bit(tmp_path, name):
    cfg, env = _setup(CASES[name])
    T = int(cfg.env.time_limit)
    family = ac if name.startswith("mappo") else dqn
    init_state, train_iteration = family.build_train_functions(env, env, cfg.algorithm, T, CPU)[:2]
    state = init_state(0)
    for _ in range(3):
        train_iteration(state)
    path = tmp_path / "checkpoints" / f"model_s{state.env_steps}.msgpack"
    save_checkpoint(path, state.state_dict())
    restored = init_state(1)  # other weights and draws, all replaced
    restored.load_state_dict(load_checkpoint(path, template=restored.state_dict()))
    assert_states_equal(state, restored)
    for _ in range(2):
        m1, m2 = train_iteration(state), train_iteration(restored)
        assert all(_same(m1[k], m2[k]) for k in m1 if k != "epsilon"), name
    assert state.updates > 0 and state.updates == restored.updates
    assert_states_equal(state, restored)
    if name == "qmix_lbf_std":
        assert float(restored.reward_stream.n.min()) > 0
    if name == "qmix_smaclite_3m":
        assert restored.buffer.action_mask is not None and restored.buffer.obs.dtype == torch.float32


@pytest.mark.parametrize("name", ["qmix_lbf_std", "mappo_rnn"])
def test_host_loop_saves_and_resumes_exactly(tmp_path, name, caplog):
    """Run A trains with save_interval; run B resumes from A's first
    checkpoint in another run dir. B's last row and final checkpoint are
    A's, byte for byte; B's rows start after the resumed step."""
    argv, E = CASES[name]
    T = int(next(a for a in argv if a.startswith("env.time_limit=")).split("=")[1])
    argv = argv + [f"env.parallel_envs={E}", f"algorithm.total_steps={3 * E * T - 1}",
                   f"algorithm.log_interval={E * T}", f"algorithm.eval_interval={E * T}",
                   f"algorithm.save_interval={2 * E * T}", "algorithm.eval_episodes=4", "seed=3", "device=cpu"]
    rows_a, state_a = run.main(argv + [f"run_dir={tmp_path / 'a'}"])
    saved = sorted((tmp_path / "a" / "checkpoints").glob("model_s*.msgpack"), key=lambda p: int(p.stem[7:]))
    assert len(saved) == 2
    first = int(saved[0].stem[7:])
    with caplog.at_level("INFO", logger="codebase_tpu_torch"):
        rows_b, state_b = run.main(argv + [f"run_dir={tmp_path / 'b'}", f"resume={saved[0]}"])
    assert f"Resumed from {saved[0]} at step {first}" in caplog.text
    assert_states_equal(state_a, state_b)
    final = tmp_path / "b" / "checkpoints" / saved[1].name
    assert final.read_bytes() == saved[1].read_bytes()
    assert int(rows_b[0]["environment_steps"]) > first
    assert rows_b[-1]["loss"] == rows_a[-1]["loss"] and rows_b[-1]["environment_steps"] == rows_a[-1]["environment_steps"]


def test_resume_refuses_another_device_type_and_auto_starts_fresh(tmp_path, caplog):
    cfg, env = _setup(CASES["idqn_matrix"])
    init_state = dqn.build_train_functions(env, env, cfg.algorithm, 1, CPU)[0]
    state = init_state(0)
    sd = state.state_dict()
    sd["generator_device"] = "cuda"
    with pytest.raises(ValueError, match="saved on cuda; this run's generator is on cpu"):
        state.load_state_dict(sd)
    argv = CASES["idqn_matrix"][0] + ["env.parallel_envs=8", "algorithm.total_steps=16", "device=cpu", "resume=auto"]
    with caplog.at_level("INFO", logger="codebase_tpu_torch"):
        run.main(argv + [f"run_dir={tmp_path}"])
    assert "resume=auto: no checkpoint found, starting fresh" in caplog.text


# ------------------------------------------------------------ across packages

CROSS = {
    "idqn": ["+algorithm=idqn", "algorithm.model.use_rnn=true", "algorithm.training_start=0",
             "algorithm.batch_size=2", "algorithm.buffer_size=8"],
    "mappo": ["+algorithm=mappo", "algorithm.model.actor.use_rnn=true", "algorithm.model.critic.use_rnn=true"],
}


def _outputs(which, model, params, obs):
    """Q-values (IDQN) or actor logits (MAPPO) of one step from zero
    hiddens: the JAX model on `params`, or the port model."""
    net = "critic" if which == "idqn" else "actor"
    if params is None:
        with torch.no_grad():
            out, _ = getattr(model, net)(torch.from_numpy(obs), None)
        return out.numpy()
    out, _ = getattr(model, net).apply(params[net], jnp.asarray(obs), None)
    return np.asarray(out)


@pytest.mark.parametrize("which", list(CROSS))
def test_each_package_evaluates_the_others_checkpoint(tmp_path, which):
    argv = CROSS[which] + ["env.name=lbforaging:Foraging-5x5-2p-1f-v3", "env.time_limit=5", "env.parallel_envs=4",
                           "algorithm.total_steps=40", "algorithm.log_interval=20", "algorithm.eval_interval=20",
                           "algorithm.save_interval=20", "algorithm.eval_episodes=4", "seed=2"]
    obs = np.random.default_rng(0).integers(-1, 6, size=(2, 1, 7, 9)).astype(np.float32)  # (N, T, B, D)

    # the JAX package trains and saves; the port's eval loads its params
    jax_run.main(argv + [f"run_dir={tmp_path / 'jax'}"])
    jax_file = latest_checkpoint(tmp_path / "jax" / "checkpoints")
    jcfg = JaxConfig(yaml.safe_load((tmp_path / "jax" / "config.yaml").read_text()))
    jenv_cfg = jcfg.env.to_dict()
    jenv_cfg.pop("parallel_envs", None)
    jenv = jax_make_env(jenv_cfg.pop("name"), **jenv_cfg)
    jmodel, _ = jax_eval.build_policy(jenv, jcfg, jax_checkpoint.load_checkpoint(jax_file))
    jparams = jax_checkpoint.load_checkpoint(jax_file)["params"]
    jparams = jax.tree.map(jnp.asarray, serialization.from_state_dict(jmodel.init_params(jax.random.PRNGKey(0)), jparams))
    cfg = Config(yaml.safe_load((tmp_path / "jax" / "config.yaml").read_text()))
    env, _ = run.build_envs(cfg)
    model, _, _ = port_eval.build_policy(env, cfg, load_checkpoint(jax_file))
    np.testing.assert_allclose(_outputs(which, model, None, obs), _outputs(which, jmodel, jparams, obs),
                               rtol=2e-4, atol=1e-5)
    # full-state resume across packages cannot be exact, and is refused
    with pytest.raises(ValueError, match="no torch.Generator state"):
        run.main(argv + ["device=cpu", f"run_dir={tmp_path / 'refused'}", f"resume={jax_file}"])

    # the port trains and saves; the JAX package's eval loads its params
    _, state = run.main(argv + ["device=cpu", f"run_dir={tmp_path / 'port'}"])
    port_file = latest_checkpoint(tmp_path / "port" / "checkpoints")
    raw = jax_checkpoint.load_checkpoint(port_file)
    jmodel, _ = jax_eval.build_policy(jenv, jcfg, raw)
    jparams = jax.tree.map(jnp.asarray, serialization.from_state_dict(jmodel.init_params(jax.random.PRNGKey(0)),
                                                                      raw["params"]))
    np.testing.assert_allclose(_outputs(which, state.model, None, obs), _outputs(which, jmodel, jparams, obs),
                               rtol=2e-4, atol=1e-5)
