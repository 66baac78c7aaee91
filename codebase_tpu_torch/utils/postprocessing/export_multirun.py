"""Export a multirun tree to one multi-indexed dataframe.

The counterpart of the JAX package's `utils/postprocessing/export_multirun.py`:
a dataframe of `mean_episode_returns` with (env, algo, config hash, seed)
column levels, plus a table from config hash to the flattened config,
written to HDF5 (or a pickle when pytables is absent). It needs pandas,
which the rest of the port's analysis does not; without it `load_multirun`
raises ImportError naming pandas.

    python -m codebase_tpu_torch.utils.postprocessing.export_multirun --folder outputs/ --export-file runs.h5
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from hashlib import sha256
from pathlib import Path

import yaml


def _pandas():
    try:
        import pandas as pd
    except ImportError as exc:
        raise ImportError("export_multirun needs pandas (pip install pandas)") from exc
    return pd


def load_multirun(folder):
    """(hash -> config table, the (env, algo, hash, seed) dataframe)."""
    pd = _pandas()
    path = Path(folder)
    data = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    seen_seeds = defaultdict(set)
    hash_to_config = {}

    for results in sorted(path.glob("**/results.csv")):
        config_path = results.parent / "config.yaml"
        if not config_path.exists():
            continue
        config = yaml.safe_load(config_path.read_text())
        env = config["env"]["name"].split(":")[-1]
        algo = config["algorithm"]["name"]
        seed = config.get("seed")
        cfg_wo_seed = {k: v for k, v in config.items() if k != "seed"}
        h = sha256(json.dumps(cfg_wo_seed, sort_keys=True, default=str).encode()).hexdigest()[:12]
        hash_to_config[h] = pd.json_normalize(cfg_wo_seed)

        series = pd.read_csv(results, index_col=0)["mean_episode_returns"]
        if seed in seen_seeds[(env, algo, h)]:
            raise ValueError(f"Duplicate seed in {results}")
        seen_seeds[(env, algo, h)].add(seed)
        data[env][algo][h].append(series.rename(f"seed={seed}"))

    env_frames = []
    for env in data:
        algo_frames = []
        for algo in data[env]:
            hash_frames = [pd.concat(data[env][algo][h], axis=1) for h in data[env][algo]]
            algo_frames.append(pd.concat(hash_frames, axis=1, keys=list(data[env][algo])))
        env_frames.append(pd.concat(algo_frames, axis=1, keys=list(data[env])))
    df = pd.concat(env_frames, axis=1, keys=list(data))
    configs = pd.concat(hash_to_config).droplevel(1)
    return configs, df


def export(folder, export_file) -> Path:
    """Write `load_multirun(folder)` to `export_file` (HDF5), or to a
    pickle beside it without pytables; returns the file written."""
    pd = _pandas()
    hash_to_config, df = load_multirun(folder)
    try:
        df.to_hdf(export_file, key="df", mode="w", complevel=9)
        hash_to_config.to_hdf(export_file, key="configs")
        return Path(export_file)
    except ImportError:
        out = Path(export_file).with_suffix(".pkl")
        pd.to_pickle({"df": df, "configs": hash_to_config}, out)
        print(f"pytables unavailable; wrote pickle to {out}")
        return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--folder", default="outputs/")
    parser.add_argument("--export-file", required=True)
    args = parser.parse_args(argv)
    if not Path(args.folder).exists():
        parser.error(f"--folder {args.folder} does not exist")
    return export(args.folder, args.export_file)


if __name__ == "__main__":
    main()
