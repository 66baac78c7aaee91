"""Analysis CLI over run directories: `summary`, `best`, `plot`.

The counterpart of the JAX package's `analyze.py`, with its command line
and output, on argparse (the JAX CLI is click's). It reads a tree of run
directories, each with `config.yaml` and `results.csv`, grouped by their
configs without the seed (`utils/postprocessing/load_data.py`), so it reads
the port's runs and the JAX package's alike.

    python -m codebase_tpu_torch.analyze summary --source outputs/ [--last-k 5]
    python -m codebase_tpu_torch.analyze best    --source outputs/ [--last-k 0] [--no-print-config]
    python -m codebase_tpu_torch.analyze plot    --source outputs/ --save-dir plots/

`summary` and `best` need numpy and yaml only; `plot` needs matplotlib and
raises ImportError naming it when it is absent.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

DEFAULT_METRIC = "mean_episode_returns"


class AnalysisError(Exception):
    """A failure the CLI reports as `Error: ...` with exit code 1."""


def _load_groups(source, metric, minimal_name=True):
    from codebase_tpu_torch.utils.postprocessing.load_data import load_and_group_runs

    groups = load_and_group_runs(Path(source), minimal_name)
    if not groups:
        raise AnalysisError(f"no runs found under {source}")
    missing = [g.name for g in groups if not g.has_metric(metric)]
    if missing:
        raise AnalysisError(f"metric {metric!r} missing from groups: {', '.join(missing)}")
    return groups


def _by_env(groups):
    envs = sorted({g.env_name for g in groups})
    return [(env, [g for g in groups if g.env_name == env]) for env in envs]


def _tail_score(group, metric, last_k):
    values = group.get_metric(metric)  # (runs, points)
    k = min(last_k, values.shape[1]) if last_k else values.shape[1]
    return values[:, -k:].mean()


def summary(source, metric=DEFAULT_METRIC, last_k=5, out=None):
    """Per-group table: runs, curve mean, final mean ± std over seeds."""
    out = out or sys.stdout
    for env, env_groups in _by_env(_load_groups(source, metric)):
        print(env, file=out)
        rows = []
        for g in sorted(env_groups, key=lambda g: -_tail_score(g, metric, last_k)):
            values = g.get_metric(metric)
            tail = values[:, -min(last_k, values.shape[1]):]
            rows.append((g.name, f"{len(g.runs)}", f"{values.mean():.4g}",
                         f"{tail.mean():.4g} ± {tail.mean(axis=1).std():.3g}"))
        header = ("group", "runs", f"curve {metric}", f"final[{last_k}] ± std(seeds)")
        widths = [max(max(len(r[i]) for r in rows), len(h)) for i, h in enumerate(header)]
        fmt = "  ".join("{:<%d}" % w for w in widths)
        print("  " + fmt.format(*header), file=out)
        for r in rows:
            print("  " + fmt.format(*r), file=out)
        print(file=out)


def best(source, metric=DEFAULT_METRIC, last_k=0, print_config=True, out=None):
    """The best hyperparameter group of each environment; returns
    {env: (group name, score)}."""
    import yaml

    out = out or sys.stdout
    winners = {}
    for env, env_groups in _by_env(_load_groups(source, metric)):
        winner = max(env_groups, key=lambda g: _tail_score(g, metric, last_k))
        score = _tail_score(winner, metric, last_k)
        winners[env] = (winner.name, float(score))
        print(f"{env}: {winner.name} ({metric}={score:.4g} over {len(winner.runs)} runs)", file=out)
        if print_config:
            print(yaml.safe_dump(winner.config, sort_keys=False), file=out)
    return winners


def plot_env(env, env_groups, metric, ax=None):
    """Mean ± std learning curves of one environment onto `ax`."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    for g in env_groups:
        steps = g.get_metric("environment_steps").mean(axis=0)
        values = g.get_metric(metric)
        mean, std = values.mean(axis=0), values.std(axis=0)
        ax.plot(steps, mean, label=g.name)
        ax.fill_between(steps, mean - std, mean + std, alpha=0.3)
    ax.set_xlabel("environment steps")
    ax.set_ylabel(metric)
    ax.set_title(env)
    ax.legend()
    return ax


def plot(source, metric=DEFAULT_METRIC, save_dir=None, show=False, minimal_name=True, out=None):
    """Mean ± std learning-curve plots, one per environment; with
    `save_dir`, one `<env>_<metric>.pdf` each. Returns the files written."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("analyze plot needs matplotlib (pip install matplotlib)") from exc
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = out or sys.stdout
    written = []
    for env, env_groups in _by_env(_load_groups(source, metric, minimal_name)):
        fig, ax = plt.subplots()
        plot_env(env, env_groups, metric, ax=ax)
        if save_dir:
            path = Path(save_dir) / f"{env.replace('/', ':')}_{metric}.pdf"
            path.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(path)
            written.append(path)
            print(f"wrote {path}", file=out)
    if show:
        plt.show()
    return written


def _flag(parser, name, default, help_on):
    """`--name/--no-name` (or the pair given) as click spells a boolean flag."""
    on, off = name if isinstance(name, tuple) else (f"--{name}", f"--no-{name}")
    dest = on.lstrip("-").replace("-", "_")
    parser.add_argument(on, dest=dest, action="store_true", default=default, help=help_on)
    parser.add_argument(off, dest=dest, action="store_false")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m codebase_tpu_torch.analyze",
                                     description="Analyse training runs (results.csv trees).")
    commands = parser.add_subparsers(dest="command", required=True)
    for name, last_k, help_k in (("summary", 5, "final score = mean of the last K eval points"),
                                 ("best", 0, "rank by mean of last K points (0 = whole curve)"),
                                 ("plot", None, None)):
        sub = commands.add_parser(name)
        sub.add_argument("--source", required=True)
        sub.add_argument("--metric", default=DEFAULT_METRIC)
        if last_k is not None:
            sub.add_argument("--last-k", type=int, default=last_k, help=help_k)
        if name == "best":
            _flag(sub, "print-config", True, "print the winner's config")
        if name == "plot":
            sub.add_argument("--save-dir", default=None, help="write one <env>_<metric>.pdf per environment")
            _flag(sub, "show", False, "show the figures")
            _flag(sub, ("--minimal-name", "--full-name"), True, "name groups by what differs")
    args = parser.parse_args(argv)
    if not Path(args.source).exists():
        parser.error(f"--source {args.source} does not exist")
    try:
        if args.command == "summary":
            summary(args.source, args.metric, args.last_k)
        elif args.command == "best":
            best(args.source, args.metric, args.last_k, args.print_config)
        else:
            plot(args.source, args.metric, args.save_dir, args.show, args.minimal_name)
    except AnalysisError as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
