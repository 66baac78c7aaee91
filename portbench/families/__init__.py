"""The port's train-loop families, one module each, chosen by a
configuration file's `family` key: `dqn` (`algos/dqn.py`: IDQN, VDN, QMIX)
and `ac` (`algos/ac.py`: IA2C, MAA2C, IPPO, MAPPO).

A family module holds what differs between the families and nothing that
the run shares (`run.py`'s window and trace, `check.verdict`, `spec`):

- `RANGES`: the program's span for each layer that the device-ms metrics
  read by layer (`rollout`, `updates`, and the DQN family's `replay_add`);
- `LIMITS`, the numbers its `judge` and its after-window check give, and
  `TRAFFIC`, the keys a workload's traffic must hold;
- `Train(cfg, env, eval_env, device, traffic, seed)`: the train state built
  by the program's `build_train_functions`, with `train_iteration`,
  `read_back` (what the port's host loop reads of an iteration's result),
  `env_steps()`, `make_weights(seed)`, `taps(seed, reference)`,
  `after_window(cell)` (the exact numbers read after the window, with the
  cell's `iterate`, `iters` and `taps`),
  `useful_flops()`, `gru_least_seconds(calls, peaks)` (the GRU call model),
  `iterations(harness_iterations)` (the divisor of the program's
  counters) and `free()`;
- `judge(taps, w0, reference, device, mode)`: the numbers compared, for the
  program ("program"), for the reference in TF32 in its place ("control")
  or for a planted fault ("half_batch").
"""

from __future__ import annotations

import importlib
import re


def load(name: str):
    """The family module `families/<name>.py`."""
    if not re.fullmatch(r"[a-z][a-z0-9_]*", str(name)):
        raise ValueError(f"no train-loop family {name!r}")
    return importlib.import_module(f"portbench.families.{name}")
