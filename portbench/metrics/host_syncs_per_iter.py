"""Host syncs per train iteration: the program's `sync/*` counters (each a
read that makes the host wait for the device: the rollout's seed, the early
exit's test, the replay insert's step count) over its `dqn/iterations`
counter, both counted since the process started (the checked first
iteration, warm-up, window, traced stretch and the target-copy iteration
alike). Read from the program's counter registry
(`codebase_tpu_torch.utils.profiling.counters`); a program without one
reads nothing. Each sync drains the launch queue and bounds a CUDA graph of
the steps between two of them."""

NAME = "host_syncs_per_iter"
UNIT = "syncs/iter"
LAYER = "host loop"
MOVES = "env_steps_per_s"
SOURCE = "program_counter"


def read(ctx):
    from codebase_tpu_torch.utils import profiling

    if not hasattr(profiling, "counters"):
        return None
    counts = profiling.counters()
    iters = counts.get("dqn/iterations")
    if not iters:
        return None
    return sum(n for k, n in counts.items() if isinstance(k, str) and k.startswith("sync/")) / iters
