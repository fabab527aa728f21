"""The bound arithmetic against the rows of PERF.md's kernel table, which
chip_smoke.py's copy of it computed from the kernels' inputs, and the
readers of the kernels' shares and of the card's idle share."""
import pytest

from benchmark import registry, roofline


@pytest.mark.parametrize("lanes,n,m,slots,n_d,expect_ms", [
    (4096, 5, 101, 5, 256, 0.00194),     # headline-GI, f32 data, f64 slots
    (4096, 3, 65, 3, 4096, 0.0020),      # per-lane SLMPC-GI
    (4096, 2, 72, 2, 4096, 0.0017),      # per-lane nonlin-GI
])
def test_bench_gi_bound_reads_perf_md_rows(lanes, n, m, slots, n_d, expect_ms):
    s, what = roofline.gi_bound_s(lanes=lanes, n=n, m=m, slots=slots, n_p=n_d, n_a=n_d,
                                  data_size=4, slot_size=8, pivots=0)
    assert what == "bytes"
    assert s * 1e3 == pytest.approx(expect_ms, rel=0.03)


def test_bench_bound_takes_the_larger_of_bytes_and_operations():
    t, what = roofline.bound_s(3.35e12, 1.0, 4)
    assert (t, what) == (1.0, "bytes")
    t, what = roofline.bound_s(1.0, 67e12 * 2, 4)
    assert (t, what) == (2.0, "operations")
    assert roofline.bound_s(1.0, 34e12, 8)[0] == 1.0


def test_bench_gi_pivots_add_operations():
    kw = dict(lanes=1000, n=33, m=577, slots=8, n_p=8, n_a=8, data_size=4, slot_size=4)
    t0, _ = roofline.gi_bound_s(pivots=0, **kw)
    t1, what = roofline.gi_bound_s(pivots=10**9, **kw)
    assert t1 > t0 and what == "operations"


def test_bench_admm_bound_is_chip_smokes_for_one_launch_of_every_lane():
    B, n, m, n_c, iters = 4096, 5, 101, 64, 10
    s = 4
    hand = s * (n_c * m * n + n_c * (n * n + m) + B * (2 * n + 4 * m) + B * (n + 2 * m)) + B * 9
    t, what = roofline.admm_bound_s(sweeps=B * iters, lane_launches=B, n=n, m=m, n_c=n_c,
                                    data_size=s)
    assert what == "bytes" and t == pytest.approx(hand / roofline.HBM_BPS)
    t2, _ = roofline.admm_bound_s(sweeps=B * iters * 10**4, lane_launches=B, n=n, m=m,
                                  n_c=n_c, data_size=s)
    flops = B * iters * 10**4 * (4 * m * n + 2 * n * n + 12 * m + 6 * n)
    assert t2 == pytest.approx(flops / roofline.PEAK_FLOPS[4])


def reader(name):
    return registry.metric_reader(name)


def test_bench_idle_share_matches_each_profiled_period_to_window_periods_like_it():
    ctx = dict(cycle_s=[0.010, 0.020, 0.022, 0.030],
               cycle_launches={"admm_sweep": [3, 6, 6, 9], "gi_solve": [0, 0, 0, 0]},
               profiled_launches={"admm_sweep": [6, 7], "gi_solve": [0, 0]},
               stretch_periods=2, trace=dict(busy_s=0.035))
    # period 1 matches the two 6-launch cycles (0.021 s); 7 launches has no
    # match, and the nearest count is 6 again
    assert reader("device.idle_share")(ctx) == pytest.approx(100 * (1 - 0.035 / 0.042))
    assert reader("device.idle_share")({**ctx, "cycle_s": []}) is None


def test_bench_sweep_roofline_reads_only_the_sweep_kernels():
    ctx = dict(kernel="admm_sweep",
               trace=dict(device=[("void admm_group_kernel<float, 2, true>(...)", 0.0, 40.0),
                                  ("void admm_warp_kernel<float>(...)", 50.0, 60.0),
                                  ("gemv", 0.0, 1000.0)]),
               profiled_launches={"admm_sweep": [2, 3]}, profiled_pivots=[100, 200],
               bound_s=lambda p, n: 1e-7 * n)
    assert reader("admm_sweep_roofline")(ctx) == pytest.approx(100 * 5e-7 / 50e-6)
    assert reader("admm_sweep_roofline")({**ctx, "kernel": "gi_solve"}) is None
