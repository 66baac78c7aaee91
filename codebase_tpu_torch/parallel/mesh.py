"""Data parallelism over GPUs on `torch.distributed`: the port's counterpart
of the JAX package's `parallel/mesh.py`.

The JAX package builds a 1-D `data` mesh and lets GSPMD insert the
collectives. Here each GPU is one process (a rank) of a process group and
the collectives are explicit, using only `all_reduce` and `broadcast`, the
collectives gloo carries for CUDA tensors too, so one code path serves NCCL
on the GPUs, gloo on the GPUs and gloo on the CPU:

- the env batch is sharded over the ranks: rank r steps envs
  `[r*E/W, (r+1)*E/W)` of the E global envs;
- the episodic replay is sharded by env slice: rank r keeps the slots its
  envs fill (`ops/replay.py`); a sampled batch is gathered from the owners
  by one zero-filled `all_reduce` of each field, and each rank takes the
  loss and gradient of its B/W rows of each update;
- params and Adam state are replicated: the gradients are summed over the
  ranks before the optimizer step, so every rank applies the same update
  and the params stay bitwise equal across ranks;
- a sweep's units are sharded over the ranks instead (`mode="unit"`): rank
  r trains units `[r*U/W, (r+1)*U/W)` as one train state.

A run over W ranks computes what the one-rank run of the same seed does,
up to the order of float sums. Every rank seeds its generator as the
one-rank run does and makes each random draw at the global shape, keeping
its own slice (`draw`), so rank r's envs see exactly the draws that envs
`[r*E/W, (r+1)*E/W)` see at W=1; a host decision that draws or skips a
draw (the collector's early exit, a sweep's "any unit can update") is
taken on the global value (`Shard.any`).

Launch: `distributed.devices` N spawns N ranks from the CLI (`spawn`, start
method spawn, a file rendezvous in a temporary directory), 1 makes a group
of one in this process, `all` uses every visible GPU; under torchrun's
variables (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`, and
`LOCAL_RANK` for the GPU) `distributed.initialize` `auto` or `always` joins
that group instead. NCCL on `cuda`, gloo on `cpu`; `spawn` also takes an
explicit backend and GPU list, so two gloo ranks can share one GPU.
"""

from __future__ import annotations

import logging
import os
import shutil
import signal
import tempfile
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist

log = logging.getLogger("codebase_tpu_torch")

# torchrun's variables; their presence marks a rank of a launched job
# (LOCAL_RANK, the rank's GPU, defaults to RANK)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# seconds a rank waits in a collective for the others before it raises
TIMEOUT_S = 600

# this process's device in its group, set when it joins one
_rank_device: Optional[torch.device] = None
# the dict the shards made from here on record their times into (None: off)
_times: Optional[dict] = None


def collect_times(times: Optional[dict]) -> None:
    """Make every `Shard` built from now on (`mesh_from_config`, `world`)
    record, into `times`, the seconds of each kind of collective and of the
    draws, each bracketed by device syncs (`Shard.timed`); None stops it."""
    global _times
    _times = times


@dataclass
class Shard:
    """This process's part of a data-parallel run, and its collectives.

    `mode` "env": the env batch and replay are split over the ranks and
    gradients summed; "unit": a sweep's units are split and each rank trains
    its own (the collectives only keep host decisions global). Without a
    `group` (a single process) every collective is the identity. `times`,
    when a dict, collects the seconds of each kind of collective and of the
    draws, each bracketed by device syncs (a measurement mode)."""

    rank: int = 0
    world: int = 1
    mode: str = "env"
    group: object = None
    device: torch.device = torch.device("cpu")
    owned: bool = False  # this process made the group and tears it down
    times: Optional[dict] = field(default=None, repr=False)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def splits_envs(self) -> bool:
        return self.distributed and self.mode == "env"

    def local(self, n: int, what: str) -> int:
        """n // world, raising ValueError unless the world divides n."""
        if n % self.world:
            raise ValueError(f"{what} ({n}) must divide evenly over {self.world} ranks")
        return n // self.world

    # ------------------------------------------------------------ timing
    @contextmanager
    def timed(self, kind: str):
        if self.times is None:
            yield
            return
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        s, n = self.times.get(kind, (0.0, 0))
        self.times[kind] = (s + time.perf_counter() - t0, n + 1)

    # ------------------------------------------------------------- draws
    def draw(self, fn: Callable, shape, env_dim: Optional[int], unit_dim: Optional[int] = None):
        """`fn(shape)` drawn at the global shape, this rank's slice kept.
        `env_dim` is the env axis of `shape` (None: replicated, the same
        draw on every rank); `unit_dim` the axis of a sweep's units where
        they are not the env axis (agents folded unit-major)."""
        dim = env_dim if self.mode == "env" or unit_dim is None else unit_dim
        if self.world == 1 or dim is None:
            with self.timed("draw"):
                return fn(tuple(shape))
        shape = list(shape)
        dim %= len(shape)
        n = shape[dim]
        shape[dim] = n * self.world
        with self.timed("draw"):
            return fn(tuple(shape)).narrow(dim, self.rank * n, n).contiguous()

    # ------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM, kind: str = "other") -> torch.Tensor:
        """`t` reduced over the ranks, in place; the identity without a group."""
        if self.group is not None:
            with self.timed(kind):
                dist.all_reduce(t, op=op, group=self.group)
        return t

    def any(self, flag, kind: str = "flag") -> bool:
        """A host flag (or a bool tensor's any) ORed over the ranks."""
        if isinstance(flag, torch.Tensor):
            flag = flag.any()
        if self.group is None:
            return bool(flag)
        t = torch.as_tensor(flag, device=self.device).to(torch.int32).reshape(1)
        return bool(self.all_reduce(t, dist.ReduceOp.MAX, kind).item())

    def env_sum(self, t: torch.Tensor, kind: str = "steps") -> torch.Tensor:
        """Summed over the env shards (identity unless the envs are split)."""
        return self.all_reduce(t, kind=kind) if self.splits_envs else t

    def env_max(self, t: torch.Tensor, kind: str = "steps") -> torch.Tensor:
        return self.all_reduce(t, dist.ReduceOp.MAX, kind) if self.splits_envs else t

    def sum_grads(self, grads) -> list:
        """Gradients summed over the ranks in one flat `all_reduce` (the
        identity unless the envs are split)."""
        if not self.splits_envs:
            return list(grads)
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce(flat, kind="grad")
        out, i = [], 0
        for g in grads:
            out.append(flat[i:i + g.numel()].view_as(g).to(g.dtype))
            i += g.numel()
        return out

    def gather_envs(self, t: torch.Tensor, dim: int = 0, kind: str = "metrics") -> torch.Tensor:
        """The global tensor of which `t` is this rank's env slice along
        `dim`, on every rank: a zero-filled `all_reduce` (adding zeros is
        exact). The identity unless the envs are split."""
        if not self.splits_envs:
            return t
        shape = list(t.shape)
        n = shape[dim]
        shape[dim] = n * self.world
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
        out.narrow(dim, self.rank * n, n).copy_(t)
        return self.all_reduce(out, kind=kind)

    def part(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's slice of `t` along `dim`: its envs of a global tensor
        (the inverse of `gather_envs`; the JAX package's `put_global` of a
        loaded checkpoint's per-env leaf), or its rows of a batch held whole
        on every rank. The identity unless the envs are split."""
        if not self.splits_envs:
            return t
        n = self.local(t.shape[dim], f"axis {dim} of a {tuple(t.shape)} tensor")
        return t.narrow(dim, self.rank * n, n)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- draws
# The envs and the policies draw through `draw`, which follows the shard of
# the rollout in flight (`envs/vector.collect_episodes` sets it): no shard,
# or one rank, draws as a single process does.

_drawing = Shard()


@contextmanager
def drawing(shard: Optional[Shard]):
    """Make `shard` the one `draw` follows inside the block."""
    global _drawing
    prev, _drawing = _drawing, shard or Shard()
    try:
        yield _drawing
    finally:
        _drawing = prev


def draw(fn: Callable, shape, env_dim: Optional[int], unit_dim: Optional[int] = None):
    """`Shard.draw` of the rollout in flight."""
    return _drawing.draw(fn, shape, env_dim, unit_dim)


# --------------------------------------------------------- process group


def available(device) -> int:
    """Devices a run can spread over: visible GPUs, or CPU cores."""
    if torch.device(str(device)).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def ranks_from_config(devices_spec, n_available: int) -> Optional[int]:
    """The rank count `distributed.devices` asks for: None for none
    (null), every available device for `all`, else N; more than are
    available raises ValueError, as the JAX package's `make_mesh` asserts."""
    if not devices_spec:
        return None
    n = n_available if str(devices_spec) == "all" else int(devices_spec)
    if n < 1 or n > n_available:
        raise ValueError(f"distributed.devices={devices_spec}: need {n} devices, have {n_available}")
    return n


def _torchrun_env() -> bool:
    return all(v in os.environ for v in TORCHRUN_VARS)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init(rank: int, world: int, device, backend: Optional[str] = None, init_method: Optional[str] = None,
         store=None) -> None:
    """Join (or make) the default process group as `rank` of `world`, with
    this rank's device; a collective that waits `TIMEOUT_S` raises."""
    global _rank_device
    device = torch.device(str(device))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} was given {device} but no CUDA GPU is visible")
        if device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    backend = backend or _backend(device)
    kwargs = dict(backend=backend, rank=rank, world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method or "env://"
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(**kwargs)
    _rank_device = device
    log.info("rank %d/%d joined a %s group on %s", rank, world, backend, device)


def rank_device() -> Optional[torch.device]:
    """The device of this process's rank; None outside a group."""
    return _rank_device if dist.is_initialized() else None


def maybe_initialize_distributed(mode="auto", device="cuda") -> bool:
    """Join the group of a torchrun-style launch from its variables.

    `auto` joins when the variables are there; `always` requires them
    (RuntimeError without); `never` (or False/None) skips. Idempotent: True
    when this process is in a group already."""
    if mode in (False, None, "never"):
        return False
    if mode not in ("auto", "always", True):
        raise ValueError(f"distributed.initialize must be auto, always or never; got {mode!r}")
    if dist.is_initialized():
        return True
    if not _torchrun_env():
        if mode == "auto":
            return False
        raise RuntimeError(
            f"distributed.initialize=always needs torchrun's variables {list(TORCHRUN_VARS)}; "
            f"missing {[v for v in TORCHRUN_VARS if v not in os.environ]}"
        )
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(str(device))
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    init(rank, world, device)
    return True


def ranks_to_spawn(dist_cfg, device) -> int:
    """How many ranks a CLI run has to spawn itself: 0 when it runs in this
    process (no `distributed.devices`, a group already joined or to be
    joined from torchrun's variables, or one device). Raises before
    anything starts when more devices are asked for than are visible, or
    `initialize=always` finds no torchrun variables."""
    if not dist_cfg or not dist_cfg.get("devices") or dist.is_initialized():
        return 0
    mode = dist_cfg.get("initialize", "auto")
    if mode not in ("auto", "always", "never", True, False, None):
        raise ValueError(f"distributed.initialize must be auto, always or never; got {mode!r}")
    if mode in ("auto", "always", True) and _torchrun_env():
        return 0
    if mode in ("always", True):
        maybe_initialize_distributed("always", device)  # raises: no variables
    n = ranks_from_config(dist_cfg.get("devices"), available(device))
    return 0 if n == 1 else n


def mesh_from_config(dist_cfg, device="cuda", mode: str = "env") -> Optional[Shard]:
    """This process's `Shard` of the group the `distributed` config node
    asks for, or None for none (`devices` null).

    Joins torchrun's group under `initialize` auto/always, takes the group
    this process is already a rank of (a spawned rank), or makes a group of
    one in this process for `devices` 1; a group it made is `owned`, and
    `release` tears it down. A group of more ranks must be spawned first (`spawn`;
    `ranks_to_spawn`). `devices` N must equal the group's size (or be
    `all`)."""
    if not dist_cfg or not dist_cfg.get("devices"):
        return None
    spec = dist_cfg.get("devices")
    device = torch.device(str(device))
    owned = not dist.is_initialized()
    maybe_initialize_distributed(dist_cfg.get("initialize", "auto"), device)
    if not dist.is_initialized():
        n = ranks_from_config(spec, available(device))
        if n != 1:
            raise RuntimeError(f"distributed.devices={spec} needs {n} ranks: launch them with "
                               "codebase_tpu_torch.parallel.mesh.spawn (the CLI does) or torchrun")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
        init(0, 1, device, store=dist.HashStore())
    world = dist.get_world_size()
    if str(spec) != "all" and int(spec) != world:
        raise ValueError(f"distributed.devices={spec}, but the job has {world} ranks")
    shard = Shard(rank=dist.get_rank(), world=world, mode=mode, group=dist.group.WORLD,
                  device=rank_device(), owned=owned, times=_times)
    log.info("data-parallel run over %d rank(s) (%s backend): rank %d on %s",
             world, dist.get_backend(), shard.rank, shard.device)
    return shard


def release(shard: Optional[Shard]) -> None:
    """Tear down the group `mesh_from_config` made in this process."""
    global _rank_device
    if shard is not None and shard.owned and dist.is_initialized():
        dist.destroy_process_group()
        _rank_device = None


def world() -> Shard:
    """A Shard over the whole default group (one rank without one)."""
    if not dist.is_initialized():
        return Shard()
    return Shard(rank=dist.get_rank(), world=dist.get_world_size(), group=dist.group.WORLD,
                 device=rank_device() or torch.device("cpu"), times=_times)


def is_coordinator() -> bool:
    """True on the rank that writes the run's files (results.csv,
    config.yaml, checkpoints, videos): rank 0, or a single process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sync_flag(local: bool) -> bool:
    """A host flag ORed over the ranks (the identity in one process). The
    host loops agree on the preemption flag at every chunk boundary, so a
    SIGTERM to one rank saves and stops every rank together. A collective:
    every rank calls it at the same point."""
    return world().any(local, kind="flag")


def assert_agreement(value: int, what: str) -> None:
    """Raise RuntimeError, naming every rank's value, unless `value` is the
    same on every rank (a collective). Guards decisions a rank makes from
    its own filesystem, such as the checkpoint `resume=auto` finds."""
    w = world()
    if not w.distributed:
        return
    vals = torch.zeros(w.world, dtype=torch.int64, device=w.device)
    vals[w.rank] = int(value)
    vals = w.all_reduce(vals).tolist()
    if any(v != vals[0] for v in vals):
        raise RuntimeError(
            f"ranks disagree on {what}: per-rank values {vals} (rank {w.rank} has {int(value)}). "
            "Every rank must see the same checkpoints: use a shared filesystem or pass an explicit resume path."
        )


def fetch_metrics(metrics: dict, shard: Optional[Shard]) -> dict:
    """A train iteration's metrics with the env-sharded entries
    (`episode_returns`, `episode_lengths`) gathered whole on every rank (a
    collective when the envs are split)."""
    if shard is None or not shard.splits_envs:
        return metrics
    out = dict(metrics)
    for k in ("episode_returns", "episode_lengths"):
        out[k] = shard.gather_envs(metrics[k])
    return out


# ---------------------------------------------------------------- launch


def _rank_entry(rank, fn, args, world, device_type, backend, device_ids, init_method, queue):
    if device_type == "cpu":
        # the ranks share the cores: one rank's intra-op threads apiece
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = torch.device(device_type) if device_type == "cpu" else torch.device("cuda", device_ids[rank])
    init(rank, world, device, backend, init_method)
    queue.put((rank, fn(*args)))
    # a rank that is done must not close the store the others still read;
    # a rank that raised exits here, and the launcher stops the others
    dist.barrier()
    dist.destroy_process_group()


def spawn(fn: Callable, world: int, device="cpu", args=(), backend: Optional[str] = None,
          device_ids=None, init_method: Optional[str] = None) -> list:
    """Run `fn(*args)` in `world` new processes (start method spawn), each a
    rank of one group on its device; returns their return values (small,
    picklable) in rank order.

    `device` `cuda` puts rank r on GPU `device_ids[r]` (default r); the
    backend is NCCL on `cuda` and gloo on `cpu` unless `backend` says (two
    gloo ranks may share one GPU: `device_ids=[0, 0]`). The rendezvous is a
    file in a new temporary directory unless `init_method` names one. When a
    rank raises or dies, the others are killed and RuntimeError carries the
    failing rank's traceback."""
    import torch.multiprocessing as mp

    device = torch.device(str(device))
    if device.type == "cuda":
        device_ids = list(range(world)) if device_ids is None else list(device_ids)
        if len(device_ids) != world:
            raise ValueError(f"{world} ranks need {world} device ids; got {device_ids}")
        have = torch.cuda.device_count()
        if any(i >= have for i in device_ids):
            raise ValueError(f"device ids {device_ids}: need {max(device_ids) + 1} GPUs, have {have}")
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="rendezvous_")
        init_method = f"file://{os.path.join(tmp, 'store')}"
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    results = {}
    forwarding = threading.current_thread() is threading.main_thread()
    previous = signal.getsignal(signal.SIGTERM) if forwarding else None
    try:
        procs = mp.start_processes(
            _rank_entry, args=(fn, args, world, device.type, backend, device_ids, init_method, queue),
            nprocs=world, join=False, start_method="spawn",
        )
        if forwarding:
            # a SIGTERM to the launcher reaches every rank, which checkpoint
            # and stop together (`utils/preemption.py`)
            signal.signal(signal.SIGTERM, lambda signum, frame: [
                os.kill(p.pid, signum) for p in procs.processes if p.is_alive()])
        try:
            while not procs.join(timeout=0.5):
                while not queue.empty():
                    rank, value = queue.get()
                    results[rank] = value
        except Exception as exc:
            raise RuntimeError(f"a rank of {world} failed; the others were stopped:\n{exc}") from None
        while not queue.empty():
            rank, value = queue.get()
            results[rank] = value
    finally:
        if forwarding:
            signal.signal(signal.SIGTERM, previous)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    missing = [r for r in range(world) if r not in results]
    if missing:
        raise RuntimeError(f"ranks {missing} of {world} returned no result")
    return [results[r] for r in range(world)]
