"""The device trace of a short traced stretch, read in memory.

`summarise(events, iters, ranges)` reduces a `torch.profiler` event list to what the
per-layer metrics read: the device operations (kernels, copies, sets) with
their spans, the device-side spans of the program's named ranges that the
cell's family names (`families/<family>.py` `RANGES`: the DQN family's
`record_function` ranges `dqn/rollout`, `dqn/replay_add`, `dqn/updates`,
the actor-critic family's `ac/rollout`, `ac/update`; and `env/step` inside
the rollout), the device time inside each range (an operation belongs to
the range whose device-side span holds its start), the busy time (the
union of the operations' spans), and the idle gaps labelled by what the
host was in at the time. No trace file is written.
"""

from __future__ import annotations

import bisect

from torch.autograd import DeviceType

def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def summarise(events, iters: int, ranges) -> dict:
    """`ranges`: the names of the program's ranges to read."""
    ranges = tuple(ranges)
    ops, spans, host = [], {r: [] for r in ranges}, []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            host.append((start, end, e.name))
            continue
        if e.name in spans:
            spans[e.name].append((start, end))
        elif not getattr(e, "is_user_annotation", False):
            ops.append((start, end, e.name))
    ops.sort()
    range_us = dict.fromkeys(ranges, 0.0)
    for name, ss in spans.items():
        ss.sort()
        starts = [s for s, _ in ss]
        for start, end, _ in ops:
            i = bisect.bisect_right(starts, start) - 1
            if i >= 0 and start < ss[i][1]:
                range_us[name] += end - start
    by_name = {}
    for start, end, name in ops:
        calls, us = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, us + (end - start))
    # busy time: the union of the operations' spans; the gaps between
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for start, end, _ in ops:
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((start - cur_e, cur_e, start))
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    return {
        "iters": iters,
        "ops_per_iter": len(ops) / iters,
        "kernels_per_iter": sum(1 for o in ops if not _is_copy(o[2])) / iters,
        "busy_us_per_iter": busy_us / iters,
        "busy_us": busy_us,
        "range_us_per_iter": {k: v / iters for k, v in range_us.items()},
        "by_name": {k: (c / iters, us / iters) for k, (c, us) in by_name.items()},
        "idle_gaps": _label_gaps(gaps, host, ranges),
    }


def _label_gaps(gaps, host, ranges):
    """Idle seconds by what the host was in at each gap's midpoint: the
    program's named ranges it was inside and the innermost host operation
    ("python" where none was running), summed by label, largest first."""
    mids = sorted(((start + end) / 2, length) for length, start, end in gaps)
    host = sorted(host)
    totals, active, i = {}, [], 0
    for mid, length in mids:
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] > mid]
        inside = [n for _, _, n in active if n in ranges]
        inner = [(e - s, n) for s, e, n in active if n not in ranges]
        op = min(inner)[1] if inner else "python"
        label = ">".join(inside + [op])
        totals[label] = totals.get(label, 0.0) + length
    return sorted(((k, v / 1e6) for k, v in totals.items()), key=lambda kv: -kv[1])
