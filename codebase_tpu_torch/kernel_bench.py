"""Paired device times of the GRU kernels of two checkouts on one card.

    python -m codebase_tpu_torch.kernel_bench [--base DIR] [--shapes a,b,...,x]
        [--kernels fwd,bwd,dw,reduce] [--rounds 2] [--tilings] [--dw-stages 8,32,128]

Loads `codebase_tpu_torch/ops/fused_gru.py` of this checkout and, with
`--base`, of another one (each builds its own `csrc/` into its own
`_build/`), makes each shape's inputs once from a seed as `chip_smoke.py`
does, and times each kernel wrapper of both in turns (base, this, this,
base; `--rounds` times) with `chip_smoke.time_ms` (runs of back-to-back
calls behind a spin kernel; the reduction on copies that exceed the L2).
Kernels: `fwd` (`gru_fwd_cuda`: `gru_fwd_kernel` at H=128, the wide
forward above), `bwd` (`gru_bwd_cuda`, the recurrence alone), `dw`
(`gru_dw_cuda`), `reduce` (`reduce_partials_cuda`). Each tree's forward
and recurrence outputs are checked bitwise against the other's.

`--tilings` also times this checkout's wide forward at every row tile and
unit split whose shared memory fits, and its wide backward recurrence at
every row tile that fits, each held bitwise equal to the default tiling's
output.

`--dw-stages` times this checkout's weight gradient with each block summing
each given number of stages (and the default, `dw_tiling`'s), on the
recurrence kernel's outputs, with the reduction's time and the largest
error of the summed partials against `gru_dw_plain`, relative to its
largest entry: how the error grows with a block's accumulation length.

Prints one JSON line a shape (the card, each kernel's times, their medians
and the ratio this / base) and a last line with the ratios of all shapes.
Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_fused_gru(root: Path, name: str):
    """The `ops/fused_gru.py` module of the checkout at `root`, under its
    own module name, its library built from that checkout's source: where
    the checkout builds and loads it in `ops/kernel_lib.py`, that file is
    loaded too, under a name of its own, and stands for the package's
    `kernel_lib` while fused_gru.py runs (this checkout's modules are
    imported by then, through `chip_smoke`)."""
    ops = root / "codebase_tpu_torch" / "ops"
    if not (ops / "kernel_lib.py").exists():
        return _load(ops / "fused_gru.py", name)
    import codebase_tpu_torch.ops as package

    key = "codebase_tpu_torch.ops.kernel_lib"
    saved = sys.modules[key], package.kernel_lib
    lib = _load(ops / "kernel_lib.py", f"{name}_kernel_lib")
    sys.modules[key] = package.kernel_lib = lib
    try:
        return _load(ops / "fused_gru.py", name)
    finally:
        sys.modules[key], package.kernel_lib = saved


def inputs(G, T, B, H, seed=0):
    """chip_smoke.py's inputs: gi, W_hh (scaled so h @ W_hh spreads alike at
    every H), b_hh, h0, dy, dhT."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    gi = torch.randn((G, T, B, 3 * H), device=dev, generator=gen)
    w = torch.randn((G, H, 3 * H), device=dev, generator=gen) * (0.1 * (128 / H) ** 0.5)
    b = torch.randn((G, 3 * H), device=dev, generator=gen) * 0.1
    h0 = torch.randn((G, B, H), device=dev, generator=gen)
    dy = torch.randn((G, T, B, H), device=dev, generator=gen)
    dhT = torch.randn((G, B, H), device=dev, generator=gen)
    return gi, w, b, h0, dy, dhT


def kernel_calls(fg, gi, w, b, h0, dy, dhT, cold_copies):
    """Each kernel's call on these inputs, as a closure, from module fg."""
    with torch.no_grad():
        y, _ = fg.gru_fwd_cuda(gi, w, b, h0)
        dgi, _, dgh_n = fg.gru_bwd_cuda(gi, w, b, h0, y, dy, dhT)
        partials = fg.gru_dw_cuda(h0, y, dgi, dgh_n)
    ring = itertools.cycle(cold_copies(partials))
    return {
        "fwd": lambda: fg.gru_fwd_cuda(gi, w, b, h0),
        "bwd": lambda: fg.gru_bwd_cuda(gi, w, b, h0, y, dy, dhT),
        "dw": lambda: fg.gru_dw_cuda(h0, y, dgi, dgh_n),
        "reduce": lambda: fg.reduce_partials_cuda(next(ring)),
    }, (y, dgi)


def sweep_tilings(fg, G, T, B, H, gi, w, b, h0, time_ms) -> list:
    """This checkout's wide forward at every row tile and unit split whose
    shared memory fits: ms each, bitwise equal to the default tiling's."""
    ref = fg.gru_fwd_cuda(gi, w, b, h0)
    out = []
    for rows in (16, 32, 64):
        for units in sorted({1, H // fg.WIDE_CHUNK if T == 1 else 1}):
            smem = fg.wide_forward_smem(T, H, rows)
            if smem > fg.SMEM_PER_BLOCK:
                continue
            tile = dict(rows=rows, units=units)
            got = fg.gru_fwd_cuda(gi, w, b, h0, tiling=tile)
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError(f"wide forward at tiling {tile} differs from the default tiling's")
            out.append({**tile, "smem": smem, "ms": time_ms(lambda: fg.gru_fwd_cuda(gi, w, b, h0, tiling=tile))})
    return out


def sweep_backward_tilings(fg, G, T, B, H, gi, w, b, h0, y, dy, dhT, time_ms) -> list:
    """This checkout's wide backward recurrence at every row tile whose
    shared memory fits: ms each, bitwise equal to the default tiling's."""
    ref = fg.gru_bwd_cuda(gi, w, b, h0, y, dy, dhT)
    out = []
    for rows in (16, 32):
        smem = fg.wide_backward_smem(H, rows)
        if smem > fg.SMEM_PER_BLOCK:
            continue
        tile = dict(rows=rows)
        got = fg.gru_bwd_cuda(gi, w, b, h0, y, dy, dhT, tiling=tile)
        if not all(torch.equal(u, v) for u, v in zip(got, ref)):
            raise AssertionError(f"wide backward at tiling {tile} differs from the default tiling's")
        out.append({**tile, "smem": smem, "ms": time_ms(lambda: fg.gru_bwd_cuda(gi, w, b, h0, y, dy, dhT, tiling=tile))})
    return out


def sweep_dw_stages(fg, G, T, B, H, h0, y, dgi, dgh_n, counts, time_ms) -> list:
    """This checkout's weight gradient at each count of stages a block sums
    (those under the shape's total, and the default): ms, the reduction's
    ms, and the error of the summed partials against `gru_dw_plain`."""
    dw_ref, db_ref = fg.gru_dw_plain(h0, y, dgi, dgh_n)
    total = fg.dw_stages(T, B)
    default = fg.dw_tiling(G, T, B, H, torch.cuda.get_device_properties(0).multi_processor_count)["stages"]
    out = []
    for spb in sorted({default, *[c for c in counts if c < total]}):
        partials = fg.gru_dw_cuda(h0, y, dgi, dgh_n, stages=spb)
        sums = fg.reduce_partials_cuda(partials)
        dw, db = sums[:, : H * 3 * H].reshape(dw_ref.shape), sums[:, H * 3 * H :]
        out.append({
            "stages": spb, "P": partials.shape[1], "default": spb == default,
            "dW_hh_rel_err": ((dw - dw_ref).abs().max() / dw_ref.abs().max()).item(),
            "db_hh_rel_err": ((db - db_ref).abs().max() / db_ref.abs().max()).item(),
            "ms": time_ms(lambda: fg.gru_dw_cuda(h0, y, dgi, dgh_n, stages=spb)),
            "reduce_ms": time_ms(lambda: fg.reduce_partials_cuda(partials)),
        })
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, default=None, help="another checkout to time in turns with this one")
    ap.add_argument("--shapes", default=None, help="comma-separated keys of chip_smoke.SHAPES (default: all)")
    ap.add_argument("--kernels", default="fwd,bwd,dw,reduce")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tilings", action="store_true", help="sweep this checkout's wide kernels' tilings")
    ap.add_argument("--dw-stages", default=None,
                    help="comma-separated counts of stages a block of the weight gradient sums: time and error each")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_bench: torch.cuda.is_available() is false; it times kernels on a CUDA GPU")
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # the smoke run's shapes and device timing

    from codebase_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    smi = chip_smoke.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    trees = {"this": load_fused_gru(ROOT, "fused_gru_this")}
    if args.base is not None:
        trees["base"] = load_fused_gru(args.base.resolve(), "fused_gru_base")
    for fg in trees.values():
        fg._library()
    order = ["base", "this", "this", "base"] if "base" in trees else ["this"]
    keys = args.shapes.split(",") if args.shapes else list(chip_smoke.SHAPES)
    kernels = args.kernels.split(",")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ratios = {}
    for key in keys:
        s = chip_smoke.SHAPES[key]
        G, T, B, H = s["G"], s["T"], s["B"], s["H"]
        data = inputs(G, T, B, H)
        calls, outs = {}, {}
        for name, fg in trees.items():
            calls[name], outs[name] = kernel_calls(fg, *data, chip_smoke.cold_copies)
        same = {name: all(torch.equal(u, v) for u, v in zip(outs[name], outs["this"])) for name in trees}
        times = {k: {name: [] for name in trees} for k in kernels}
        for _ in range(args.rounds):
            for name in order:
                for k in kernels:
                    times[k][name].append(chip_smoke.time_ms(calls[name][k]))
        med = {k: {name: statistics.median(v) for name, v in t.items()} for k, t in times.items()}
        line = {"shape": key, "G": G, "T": T, "B": B, "H": H, "card": smi, "ms": times, "median_ms": med,
                "outputs_bitwise_equal_to_this": same,
                "dw_tiling": trees["this"].dw_tiling(G, T, B, H, sms)}
        if args.dw_stages:
            h0, (y, dgi) = data[3], outs["this"]
            dgh_n = trees["this"].gru_bwd_cuda(*data[:4], y, *data[4:])[2]
            line["dw_stages"] = sweep_dw_stages(trees["this"], G, T, B, H, h0, y, dgi, dgh_n,
                                                [int(c) for c in args.dw_stages.split(",")], chip_smoke.time_ms)
        if H != 128:
            line["tiling"] = trees["this"].wide_forward_tiling(G, T, B, H, sms)
            line["backward_tiling"] = trees["this"].wide_backward_tiling(G, T, B, H, sms)
            if args.tilings:
                line["tilings"] = sweep_tilings(trees["this"], G, T, B, H, *data[:4], chip_smoke.time_ms)
                line["backward_tilings"] = sweep_backward_tilings(
                    trees["this"], G, T, B, H, *data[:4], outs["this"][0], *data[4:], chip_smoke.time_ms)
        if "base" in trees:
            line["this_over_base"] = {k: m["this"] / m["base"] for k, m in med.items()}
            ratios[key] = line["this_over_base"]
        print(json.dumps(line), flush=True)
        del calls, outs, data
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "this_over_base": ratios}), flush=True)


if __name__ == "__main__":
    main()
