"""A cell at a size the CPU runs in seconds, for the tests."""

from portbench import spec

TINY = {"parallel_envs": 64, "batch_size": 32, "updates_per_collect": 4, "buffer_size": 256}


def tiny_workload(cell="idqn_rnn_lbf.collect"):
    return dict(spec.workload(cell), traffic=dict(TINY))
