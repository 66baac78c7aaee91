"""HiPlot experiment fetcher over exported multirun files.

The counterpart of the JAX package's `utils/postprocessing/hiplot_fetcher.py`:
resolves `exp://<export-file>/<env>/<alg>` URIs against an
`export_multirun` file: for each config hash, the best mean-across-seeds
performance becomes one HiPlot row beside that config's flattened
hyperparameters. Needs pandas (to read the export) and hiplot (to serve
it); each missing one raises ImportError naming it.

    hiplot codebase_tpu_torch.utils.postprocessing.hiplot_fetcher.experiment_fetcher

and enter `exp://filename.h5/envname/alg` in the textbox.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from codebase_tpu_torch.utils.postprocessing.export_multirun import _pandas


class NumpyEncoder(json.JSONEncoder):
    """A JSON encoder that takes numpy scalars and arrays."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.complexfloating):
            return {"real": obj.real, "imag": obj.imag}
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.void):
            return None
        return json.JSONEncoder.default(self, obj)


def _load_export(path):
    pd = _pandas()
    try:
        return pd.read_hdf(path, "df"), pd.read_hdf(path, "configs")
    except (ImportError, OSError):
        blob = pd.read_pickle(path)
        return blob["df"], blob["configs"]


def fetch_rows(export_file, env, alg):
    """The best-performance row of each config hash of one (env, alg)."""
    df, configs = _load_export(export_file)
    # the mean across seeds, then the best value over training
    summary = df.T.groupby(level=[0, 1, 2]).mean().T.max()
    data = defaultdict(lambda: defaultdict(list))
    for env_name in summary.index.get_level_values(0).unique():
        env_df = summary.xs(env_name)
        for alg_name in env_df.index.get_level_values(0).unique():
            for h, perf in env_df.xs(alg_name).items():
                data[env_name][alg_name].append({**configs.loc[h].to_dict(), "performance": perf, "uid": h})
    return json.loads(json.dumps(data[env][alg], cls=NumpyEncoder))


def experiment_fetcher(uri):
    try:
        import hiplot as hip
    except ImportError as exc:
        raise ImportError("hiplot_fetcher needs hiplot (pip install hiplot)") from exc

    prefix = "exp://"
    if not uri.startswith(prefix):
        raise hip.ExperimentFetcherDoesntApply()
    export_file, env, alg = uri[len(prefix):].split("/")[:3]
    return hip.Experiment.from_iterable(fetch_rows(export_file, env, alg))


if __name__ == "__main__":
    print('Run with "hiplot codebase_tpu_torch.utils.postprocessing.hiplot_fetcher.experiment_fetcher"')
    print('And enter "exp://filename.h5/envname/alg" in the textbox')
