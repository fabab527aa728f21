"""Share of a period the card does nothing: 1 − device busy ÷ period wall
over the profiled stretch's periods.  The busy time (the union of the
card's kernels, copies and sets) is the profiled stretch's; each profiled
period's wall is the mean whole cycle (start to the next start) of the
same run's unprofiled window periods that launched the same kernels as
often (the nearest such count where none did), since the profiler slows
the host and not the device, and a period's device work follows its
launches (ADMM's outer loop runs 6–11 sweep launches).  Where the card is
busy throughout, the reading can fall a little below 0."""
import statistics


def read(ctx):
    cycles, launches = ctx["cycle_s"], ctx["cycle_launches"]
    if not cycles:
        return None
    names = sorted(launches)
    window = [tuple(launches[n][j] for n in names) for j in range(len(cycles))]
    wall = 0.0
    for j in range(ctx["stretch_periods"]):
        want = tuple(ctx["profiled_launches"][n][j] for n in names)
        dist = [sum(abs(a - b) for a, b in zip(w, want)) for w in window]
        near = min(dist)
        wall += statistics.fmean(c for c, d in zip(cycles, dist) if d == near)
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / wall)
