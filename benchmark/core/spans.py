"""The readers of the per-layer metrics that read the program's own spans
and counters (``supernet_tpu_torch/tracing.py``): its ranges in the profiled
stretch (``Stretch.host``, on the profiler's clock beside the device's
records), the device times of its records and its counters. A program
without them (a checkout before the spans) leaves nothing to read, and each
reader then returns None."""

import statistics

STAGE = ("session.stage_in", "session.stage_out")
STEP = "train.step"
PHASES = ("train.forward", "train.backward", "train.update")  # in the order they run
# the most by which the clock offsets of the profiled steps' forward records
# against their ranges may differ (a record reads the clock a few us after its
# range's own reading, a descheduled thread later); the profiled steps lie
# tens of ms apart
MATCH_US = 5000.0


def _tracing():
    try:
        from supernet_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def unit_ms(stretch, names):
    """For each profiled unit (``bench.unit``), the summed length in ms of the
    host ranges named in ``names`` that lie inside it; None when no unit
    holds one."""
    if stretch is None or not stretch.unit_spans:
        return None
    per, found = [], False
    for a, b in stretch.unit_spans:
        inside = [e - s for n, s, e in stretch.host if n in names and a <= s and e <= b]
        found = found or bool(inside)
        per.append(1e-3 * sum(inside))
    return per if found else None


def median_unit_ms(ctx, names):
    """The median over the profiled requests of :func:`unit_ms`."""
    if ctx.kind != "serve":
        return None
    per = unit_ms(ctx.stretch, names)
    return None if per is None else statistics.median(per)


def device_ms(ctx, name):
    """The device's busy time in ms per profiled step inside the phase
    ``name`` (``PHASES``). The program's CUDA events (its records'
    ``device_ms``) tile each step's work on the device in order: forward,
    backward, update. The step's forward starts on the device when its host
    range starts, or when the work before it ends if that is later; the
    phase's interval follows from the events' times, and the device records
    inside it are the phase's work. The events alone would read idle time
    too: under the profiler the host runs two to three times slower than
    untraced, and the device waits on it inside every phase."""
    tracing = _tracing()
    st = ctx.stretch
    if tracing is None or st is None or not st.device or not st.units:
        return None
    recs = tracing.records()
    starts = sorted(s for n, s, _ in st.host if n == PHASES[0])
    roots = profiled_roots(recs, st)
    if roots is None:
        return None
    times = {root: {} for root in roots}
    for r in recs:
        if r["root"] in times and r["name"] in PHASES:
            times[r["root"]][r["name"]] = r["device_ms"]
    if any(t.get(p) is None for t in times.values() for p in PHASES):
        return None
    busy = 0.0
    for root, h in zip(roots, starts):
        a = max([h] + [e for _, s, e in st.device if s < h])
        for phase in PHASES:
            b = a + 1e3 * times[root][phase]
            if phase == name:
                busy += st.busy_us([(a, b)])
            a = b
    return 1e-3 * busy / st.units


def profiled_roots(recs, stretch):
    """The ids of the ``train.step`` roots of the stretch's profiled steps,
    in order: the run of consecutive roots whose ``train.forward`` records
    lie on the stretch's ``train.forward`` ranges, the records on the Unix
    clock and the ranges on the profiler's, so that one offset joins every
    start and one every end. Of the runs whose starts and whose ends each
    lie within ``MATCH_US`` of one offset, the one closest to them; None if
    there is none, so that steps recorded before or after the stretch
    (tracing on outside the profiler) never stand in."""
    ranges = sorted((s, e) for n, s, e in stretch.host if n == PHASES[0])
    if len(ranges) != stretch.units:
        return None
    fwd = {r["root"]: r for r in recs if r["name"] == PHASES[0]}
    roots = [r["id"] for r in recs if r["name"] == STEP and r["parent"] is None
             and r["id"] in fwd]
    best, spread = None, MATCH_US
    for k in range(len(roots) - stretch.units + 1):
        run = roots[k:k + stretch.units]
        worst = 0.0
        for key, i in (("start_ns", 0), ("end_ns", 1)):
            offsets = [1e-3 * fwd[root][key] - r[i] for root, r in zip(run, ranges)]
            worst = max(worst, max(offsets) - min(offsets))
        if worst <= spread:
            best, spread = run, worst
    return best


def counter_share(ctx, part, whole):
    """100 x the counter ``part`` over the counter ``whole`` (the program's
    counts over the whole run)."""
    tracing = _tracing()
    if tracing is None or ctx.kind != "serve":
        return None
    counts = tracing.counters()
    if not counts.get(whole):
        return None
    return 100.0 * counts.get(part, 0) / counts[whole]
