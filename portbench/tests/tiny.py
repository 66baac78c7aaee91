"""A cell at a size the CPU runs in seconds, for the tests."""

from portbench import spec

TINY = {"parallel_envs": 64, "batch_size": 32, "updates_per_collect": 4, "buffer_size": 256}
TINY_AC = {"parallel_envs": 64}


def tiny_traffic(config: str) -> dict:
    """The tiny traffic of a configuration's family."""
    return dict(TINY_AC if spec.config(config)["family"] == "ac" else TINY)


def tiny_workload(cell="idqn_rnn_lbf.collect"):
    w = spec.workload(cell)
    return dict(w, traffic=tiny_traffic(w["config"]))
