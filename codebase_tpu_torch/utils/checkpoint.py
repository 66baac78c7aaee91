"""Full-state checkpoints with exact resume, in the JAX package's format.

A checkpoint is the msgpack of `{"meta": {"format", "version"}, "state":
state_dict}` (schema v1), written by the port's own codec
(`utils/msgpack.py`) in flax's byte layout: the JAX package reads the
port's files and the port reads the JAX package's. `state_dict` is a
nested dict whose leaves are arrays (flax's ext type 1), None or plain
values; the train states build theirs with `DQNTrainState.state_dict()` and
`ACTrainState.state_dict()` from the helpers here, keyed like the JAX
package's train states, with the networks' parameters in flax's state-dict
form (lists become maps keyed "0", "1", ...).

Loading with a `template` (a state dict of the run being resumed) checks
the structure first and raises ValueError on any mismatch; loading without
one returns the raw nested dict, which is all the eval CLI needs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from codebase_tpu_torch.parallel import mesh
from codebase_tpu_torch.utils import msgpack
from codebase_tpu_torch.utils.params import tree_leaves

CHECKPOINT_FORMAT = "codebase_tpu-checkpoint"
SCHEMA_VERSION = 1

# the first byte of a pickle stream of protocol 2 or later
_PICKLE_MAGIC = b"\x80"


def save_checkpoint(path, state_dict) -> int:
    """Write `state_dict` to `path` (write-then-rename, so a crash never
    leaves a torn checkpoint). Returns the file's size in bytes."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"meta": {"format": CHECKPOINT_FORMAT, "version": SCHEMA_VERSION}, "state": state_dict}
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        for piece in msgpack.serialize_pieces(payload):
            f.write(piece)
    tmp.replace(path)
    return path.stat().st_size


def load_checkpoint(path, template=None):
    """The checkpoint's state dict. With a `template` state dict, first check
    that the two have the same structure (keys, None leaves, array shapes
    and dtypes) and raise ValueError where they differ."""
    blob = Path(path).read_bytes()
    if blob[:1] == _PICKLE_MAGIC:
        raise ValueError(
            f"{path} is an old unversioned pickle checkpoint (round-1 format); "
            "re-save it with the current framework. Refusing to unpickle: "
            "pickle executes arbitrary code on load."
        )
    try:
        payload = msgpack.deserialize(blob)
    except Exception as exc:
        raise ValueError(f"{path} is not a {CHECKPOINT_FORMAT} msgpack file: {exc}") from exc
    meta = payload.get("meta") if isinstance(payload, dict) else None
    if not meta or meta.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"{path} has no {CHECKPOINT_FORMAT} meta header (checkpoint schema unknown)")
    if int(meta.get("version", -1)) != SCHEMA_VERSION:
        raise ValueError(
            f"{path} has checkpoint schema v{meta.get('version')}; this build reads v{SCHEMA_VERSION}"
        )
    state_dict = payload["state"]
    if template is not None:
        check_structure(template, state_dict, path)
    return state_dict


def check_structure(template, state_dict, path) -> None:
    """Raise ValueError unless `state_dict` has the structure of
    `template`: the same keys, None where it has None, and arrays of the
    same shapes and dtypes."""
    problems = list(_mismatches(template, state_dict, ""))
    if problems:
        raise ValueError(f"checkpoint structure mismatch for {path}: " + "; ".join(problems[:10]))


def _describe(x):
    """(shape, dtype name) of an array leaf, else None."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    if isinstance(x, np.ndarray):
        return tuple(x.shape), x.dtype.name
    return None


def _mismatches(template, loaded, where):
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            yield f"{where or 'state'}: expected a map, found {type(loaded).__name__}"
            return
        for k in sorted(set(template) | set(loaded), key=str):
            if k not in loaded:
                yield f"{where}/{k}: missing"
            elif k not in template:
                yield f"{where}/{k}: not in this run's state"
            else:
                yield from _mismatches(template[k], loaded[k], f"{where}/{k}")
    elif (template is None) != (loaded is None):
        yield f"{where}: expected {'None' if template is None else 'a value'}, found {type(loaded).__name__}"
    elif _describe(template) != _describe(loaded):
        yield f"{where}: expected (shape, dtype) {_describe(template)}, found {_describe(loaded)}"


def resolve_resume(resume, run_dir):
    """The checkpoint path named by the `resume` config value, or None.

    `resume=auto` takes the latest checkpoint under `<run_dir>/checkpoints`
    and None when there is none: the relaunch after a preemption (with
    `utils/preemption.PreemptionGuard`). Any other non-empty value is a
    checkpoint path."""
    if not resume:
        return None
    if str(resume) == "auto":
        try:
            return latest_checkpoint(Path(run_dir) / "checkpoints")
        except FileNotFoundError:
            return None
    return Path(resume)


def latest_checkpoint(ckpt_dir) -> Path:
    """The `model_s{step}.*` file with the highest step (`*.tmp` ignored)."""
    ckpt_dir = Path(ckpt_dir)
    candidates = [p for p in ckpt_dir.glob("model_s*") if not p.name.endswith(".tmp")]
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return max(candidates, key=lambda p: int(p.stem.split("_s")[-1]))


# ------------------------------------------------ train state <-> state dict


def params_state_dict(tree):
    """A parameter tree (dicts and lists of tensors) in flax's state-dict
    form: lists become maps keyed "0", "1", ...; leaves are detached."""
    if isinstance(tree, dict):
        return {k: params_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): params_state_dict(v) for i, v in enumerate(tree)}
    return tree.detach()


def tree_from_state_dict(template, state_dict):
    """The inverse of `params_state_dict`, shaped by `template`: maps keyed
    "0", "1", ... become lists where the template has lists. Raises
    ValueError on a key the state dict lacks."""
    if isinstance(template, dict):
        _check_keys(template, state_dict)
        return {k: tree_from_state_dict(v, state_dict[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        _check_keys({str(i): None for i in range(len(template))}, state_dict)
        return [tree_from_state_dict(v, state_dict[str(i)]) for i, v in enumerate(template)]
    return state_dict


def _check_keys(template: dict, state_dict) -> None:
    if not isinstance(state_dict, dict) or set(map(str, template)) != set(state_dict):
        found = sorted(state_dict) if isinstance(state_dict, dict) else type(state_dict).__name__
        raise ValueError(f"parameter state dict has keys {found}; expected {sorted(map(str, template))}")


def as_tensor(x, device) -> torch.Tensor:
    """A loaded array leaf as a tensor on `device`."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device)


@torch.no_grad()
def load_leaves(dst: list, src: list) -> None:
    """Copy loaded array leaves into the tensors `dst`, in place."""
    if len(dst) != len(src):
        raise ValueError(f"state has {len(src)} leaves; expected {len(dst)}")
    for d, s in zip(dst, src):
        s = as_tensor(s, d.device)
        if tuple(d.shape) != tuple(s.shape):
            raise ValueError(f"leaf shape {tuple(s.shape)}; expected {tuple(d.shape)}")
        d.copy_(s)


def load_params_state_dict(param_tree, state_dict) -> None:
    """Copy a flax-form parameter state dict into the tensors of
    `param_tree`, in place."""
    load_leaves(tree_leaves(param_tree), tree_leaves(tree_from_state_dict(param_tree, state_dict)))


def counter(n) -> np.ndarray:
    """A step counter as the JAX package stores it: a 0-d int32 array."""
    return np.asarray(int(n), dtype=np.int32)


def dataclass_state_dict(obj) -> dict | None:
    """The tensor fields of a running-moments dataclass (or None)."""
    if obj is None:
        return None
    return {k: v.detach() for k, v in vars(obj).items()}


def load_dataclass(cls, state_dict, device):
    """A new `cls` (frozen dataclass of tensors) from its state dict, on
    `device`; None for None."""
    if state_dict is None:
        return None
    return cls(**{k: as_tensor(v, device) for k, v in state_dict.items()})


def generator_state_dict(generator: torch.Generator) -> dict:
    """`generator` (its state as a uint8 array) and `generator_device` (the
    device type the state belongs to: a CUDA generator's state is its seed
    and offset, 16 bytes; a CPU generator's is 5056 bytes)."""
    return {"generator": generator.get_state().numpy().copy(), "generator_device": generator.device.type}


def check_generator(state_dict, generator: torch.Generator) -> None:
    """Raise ValueError unless `state_dict` holds a generator state of
    `generator`'s device type. A checkpoint with none (one the JAX package
    wrote) cannot be resumed exactly: the port's draws are not threefry's.
    A state saved on another device type is refused, never reseeded."""
    if "generator" not in state_dict:
        raise ValueError(
            "the checkpoint holds no torch.Generator state (`generator`): it was not written by "
            "codebase_tpu_torch (the JAX package's checkpoints carry a threefry `key`), so it "
            "cannot be resumed exactly here. Its `params` load into the eval CLI "
            "(python -m codebase_tpu_torch.eval)."
        )
    saved = str(state_dict.get("generator_device"))
    if saved != generator.device.type:
        raise ValueError(
            f"the checkpoint's generator state was saved on {saved}; this run's generator is on "
            f"{generator.device.type}. A generator state cannot move between device types: "
            f"resume on {saved}."
        )


def load_generator(generator: torch.Generator, state_dict) -> None:
    """Restore `generator` from a state dict made by `generator_state_dict`."""
    check_generator(state_dict, generator)
    generator.set_state(torch.from_numpy(np.array(state_dict["generator"], dtype=np.uint8)))


# ------------------------------------------- data-parallel runs: global layout
# A checkpoint of a W-rank run has the one-rank run's schema and layout, so
# it resumes at any W: the per-env leaves (replay slots, reward streams) are
# assembled whole on save (a zero-filled all_reduce, on every rank) and
# each rank keeps its env slice on load (`parallel/mesh.py`).


def _splits(shard) -> bool:
    return shard is not None and shard.splits_envs


def global_slots(t: torch.Tensor, shard, n_envs: int) -> torch.Tensor:
    """A rank's replay slots (S/W, ...) in the global slot order (S, ...):
    global slot g holds env g % E (`ops/replay.py`)."""
    if not _splits(shard):
        return t
    local = t.reshape((-1, n_envs // shard.world) + t.shape[1:])
    return shard.gather_envs(local, 1, "state").reshape((-1,) + t.shape[1:])


def local_slots(x, shard, n_envs: int, device) -> torch.Tensor:
    """The inverse of `global_slots` on a loaded leaf."""
    t = as_tensor(x, device)
    if not _splits(shard):
        return t
    return shard.part(t.reshape((-1, n_envs) + t.shape[1:]), 1).reshape((-1,) + t.shape[1:])


def global_envs(state_dict, shard):
    """A per-env state dict (leading env axis on every leaf, or None) with
    the whole env batch on every rank."""
    if state_dict is None or not _splits(shard):
        return state_dict
    return {k: shard.gather_envs(v, 0, "state") for k, v in state_dict.items()}


def local_envs(state_dict, shard, device):
    """The inverse of `global_envs` on a loaded state dict."""
    if state_dict is None or not _splits(shard):
        return state_dict
    return {k: shard.part(as_tensor(v, device), 0) for k, v in state_dict.items()}


# ------------------------------------------------------- the host loops' use


def resume_train_state(state, resume, run_dir, logger):
    """Restore `state` (a train state with `load_state_dict`) from the
    checkpoint the `resume` config value names, logging where from, as the
    JAX package's host loops do. Returns the checkpoint's path or None.

    In a data-parallel run every rank resolves `resume` on its own
    filesystem and loads the file; the ranks must agree on the checkpoint's
    step (RuntimeError naming each rank's otherwise)."""
    path = resolve_resume(resume, run_dir)
    step = path.stem.split("_s")[-1] if path else "-1"
    mesh.assert_agreement(int(step) if step.lstrip("-").isdigit() else 0, "the step of the checkpoint to resume from")
    if path:
        state.load_state_dict(load_checkpoint(path), path)
        logger.info(f"Resumed from {path} at step {state.env_steps}")
    elif resume:
        logger.info("resume=auto: no checkpoint found, starting fresh")
    return path


def save_train_state(state, run_dir, step: int, logger) -> Path:
    """Write `<run_dir>/checkpoints/model_s{step}.msgpack`. In a
    data-parallel run every rank calls this (the state is assembled by a
    collective) and only the coordinator writes."""
    path = Path(run_dir) / "checkpoints" / f"model_s{step}.msgpack"
    state_dict = state.state_dict()
    if mesh.is_coordinator():
        nbytes = save_checkpoint(path, state_dict)
        logger.info(f"Saved checkpoint {path} ({nbytes} bytes)")
    return path
