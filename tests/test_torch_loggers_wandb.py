"""The port's wandb logger against the JAX package's: with a stub `wandb`
module, both make the same `wandb.init` call and log the same rows; without
`wandb`, `logger=wandb` raises ImportError in both."""

import sys
import types

import numpy as np
import pytest

from codebase_tpu import config as jax_config
from codebase_tpu.utils import loggers as jax_loggers
from codebase_tpu_torch import config as port_config
from codebase_tpu_torch.utils import loggers as port_loggers

CONFIG = {
    "seed": 3,
    "project_name": "gate",
    "logger": "wandb",
    "algorithm": {"name": "idqn", "total_steps": 1000, "lr": 3.0e-4, "model": {"layers": [64, 64]}},
    "env": {"name": "Foraging-5x5-2p-1f-v3", "time_limit": 5},
}


def _metrics(rng):
    """Episode infos, a loss row and the counters, as the host loops log them."""
    infos = [{"episode_returns": rng.random(2).astype(np.float32), "episode_length": float(rng.integers(1, 6)),
              "agent0/episode_returns": float(rng.random()), "agent1/episode_returns": float(rng.random())}
             for _ in range(4)]
    return infos + [{"loss": float(rng.random())}, {"updates": 7, "environment_steps": 1000}]


class _StubWandb(types.ModuleType):
    """Records each `init` call's kwargs and each run's logged dicts."""

    def __init__(self):
        super().__init__("wandb")
        self.inits, self.logged = [], []

    def init(self, **kwargs):
        self.inits.append(kwargs)
        logged = []
        self.logged.append(logged)
        return types.SimpleNamespace(log=logged.append)


def _drive(make_logger, config_cls, tmp_path, seed):
    logger = make_logger(config_cls({**CONFIG}), tmp_path)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        logger.log_metrics(_metrics(rng))
    return logger


def test_wandb_logger_makes_the_jax_packages_init_and_logs(monkeypatch, tmp_path):
    stub = _StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    jax_logger = _drive(jax_loggers.make_logger, jax_config.Config, tmp_path / "jax", 0)
    port_logger = _drive(port_loggers.make_logger, port_config.Config, tmp_path / "port", 0)
    assert isinstance(jax_logger, jax_loggers.WandbLogger)
    assert isinstance(port_logger, port_loggers.WandbLogger)
    jax_init, port_init = stub.inits
    assert port_init == jax_init
    assert port_init["group"] == jax_config.Config({**CONFIG}).hash() and len(port_init["group"]) == 10
    assert port_logger.config_hash == jax_logger.config_hash
    jax_rows, port_rows = stub.logged
    assert len(port_rows) == 3 and port_rows == jax_rows
    assert port_rows[0]["environment_steps"] == 1000 and "mean_episode_returns" in port_rows[0]


def test_config_hash_ignores_the_seed_like_the_jax_package():
    other_seed = port_config.Config({**CONFIG, "seed": 4})
    assert other_seed.hash() == port_config.Config({**CONFIG}).hash()
    other_lr = port_config.Config({**CONFIG, "algorithm": {**CONFIG["algorithm"], "lr": 1e-3}})
    assert other_lr.hash() != port_config.Config({**CONFIG}).hash()
    assert other_lr.hash() == jax_config.Config(other_lr.to_dict()).hash()


def test_wandb_logger_without_wandb_raises_import_error_in_both(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises ImportError
    for make_logger, config_cls in ((jax_loggers.make_logger, jax_config.Config),
                                    (port_loggers.make_logger, port_config.Config)):
        with pytest.raises(ImportError):
            make_logger(config_cls({**CONFIG}), tmp_path)
