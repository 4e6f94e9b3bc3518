"""The trace reduction on a synthetic timeline: busy time is the union of
overlapping kernels, idle gaps are named by the innermost host range."""

from isacbench import trace


def _tr():
    return trace.Trace(
        window=(0, 100),
        kernels=[("k_a", 10, 30), ("k_b", 20, 40), ("ldpc_layered_kernel", 60, 70),
                 ("k_c", 95, 120)],
        copies=[("Memcpy HtoD", 35, 45)],
        ranges=[("bench.window", 0, 100), ("cell.plan", 0, 12), ("cell.dl_rx", 45, 90),
                ("pdsch.rx.estimate", 50, 55)],
    )


def test_union_and_busy():
    assert trace.union([(10, 30), (20, 40), (35, 45), (60, 70)]) == [[10, 45], [60, 70]]
    assert trace.union([(95, 120)], 0, 100) == [[95, 100]]
    # kernels 10-40 overlap (30 ns union, 50 summed), copy to 45, 60-70, 95-100
    assert trace.busy_ns(_tr()) == 35 + 10 + 5


def test_idle_gaps_and_their_ranges():
    tr = _tr()
    assert trace.idle_gaps(tr) == [(0, 10), (45, 60), (70, 95)]
    names = trace.innermost_ranges(tr.ranges, [5, 52, 82])
    assert names == ["cell.plan", "pdsch.rx.estimate", "cell.dl_rx"]
    bd = trace.breakdown(tr)
    # a gap is named by the range open at its middle: 45-60 by the estimate
    assert dict((k, v) for k, v in bd["idle_gaps"]) == {
        "cell.plan": 10e-9, "pdsch.rx.estimate": 15e-9, "cell.dl_rx": 25e-9}
    ops = dict(bd["device_ops"])
    assert ops["k_a"] == 20e-9 and "k_c" not in ops


def test_families():
    fam = trace.families(_tr())
    assert fam["ldpc_layered"]["launches"] == 1 and fam["other"]["launches"] == 2
