"""``harness/spans.py`` on synthetic profiler events, and on the CPU
profiler's own events of a small net of the port: a device op goes to the
innermost ``spconv.*`` span at its launch by correlation id and not by
overlap, a backward op to its forward's span by sequence number, the
idle gaps split by the port ranges open at their start; and
``span_times.py``'s parts at the rehearsal size."""

import torch

from h100_bench import span_times
from h100_bench.harness import spans, spec
from h100_bench.harness.spans import Ev

MAIN, AUTOGRAD = 1, 2


def rng(name, start, end, tid=MAIN, **kw):
    return Ev(name, "range", tid, start, end, **kw)


def op(name, start, end, corr, tid=MAIN, **kw):
    return Ev(name, "op", tid, start, end, corr=corr, **kw)


def dev(name, start, end, linked=0, corr=0):
    return Ev(name, "device", 0, start, end, corr=corr, linked=linked)


def test_device_op_goes_to_the_span_at_its_launch():
    """A kernel launched in ``spconv.rulebook`` runs on the device while
    the host is already in ``spconv.product``: it goes to the rulebook.
    A copy found by its runtime call alone is placed at that call (here
    on a thread with no span); it, an op with no launch and an op
    launched outside every span are outside.  Every µs lands
    somewhere."""
    events = [
        rng("SubMConv3d", 0, 100),
        rng("spconv.rulebook", 1, 10),
        op("aten::sort", 2, 4, corr=11),
        rng("spconv.product", 10, 40),
        op("spconv_tpu_torch::dg_gather_gemm", 12, 14, corr=12),
        rng("spconv.epilogue", 40, 50),
        Ev("cudaMemcpyAsync", "runtime", 99, 42, 43, corr=500),
        op("aten::add", 60, 61, corr=13),
        dev("sort_kernel", 15, 30, linked=11),     # overlaps the product
        dev("dg_fwd_bf16_kernel", 30, 70, linked=12),
        dev("Memcpy DtoD", 70, 71, corr=500),
        dev("add_kernel", 71, 72, linked=13),
        dev("orphan", 72, 75),
    ]
    att = spans.attribute(events, calls=1)
    assert att.by_span == {"spconv.rulebook": 15.0, "spconv.product": 40.0}
    # the runtime call's thread holds no span: outside, as the orphan
    assert att.outside == 1.0 + 1.0 + 3.0 and att.unlaunched == 3.0
    assert sum(att.by_span.values()) + att.outside == att.total == 60.0
    assert att.summary()["closure"] == 0.0
    assert att.span_ms("spconv.rulebook") == 15.0 / 1e3
    assert att.span_ms("spconv.bn") is None


def test_backward_op_goes_to_its_forward_span():
    """A backward node with no span around it reaches the forward op of
    its sequence number on the forward's thread, and the span around
    that op; a node whose forward lies outside every span stays outside;
    ops inside ``spconv.dgrad`` keep that span."""
    events = [
        rng("spconv.bn", 0, 20),
        op("aten::mul", 1, 2, corr=1, seq=7),
        op("aten::sub", 3, 4, corr=2, seq=8),
        rng("spconv.epilogue", 20, 30),
        op("aten::where", 21, 22, corr=3, seq=9),
        op("aten::pow", 40, 41, corr=4, seq=10),        # the loss
        # backward, on the engine's thread
        op("autograd::engine::evaluate_function: PowBackward0", 100, 110,
           corr=20, tid=AUTOGRAD, seq=10, fwd_tid=MAIN),
        op("aten::mul", 101, 102, corr=21, tid=AUTOGRAD),
        op("autograd::engine::evaluate_function: WhereBackward0", 110, 120,
           corr=22, tid=AUTOGRAD, seq=9, fwd_tid=MAIN),
        rng("WhereBackward0", 110, 120, tid=AUTOGRAD, seq=9, fwd_tid=MAIN),
        op("aten::where", 111, 112, corr=23, tid=AUTOGRAD),
        op("autograd::engine::evaluate_function: MulBackward0", 120, 130,
           corr=24, tid=AUTOGRAD, seq=7, fwd_tid=MAIN),
        op("aten::mul", 121, 122, corr=25, tid=AUTOGRAD),
        op("autograd::engine::evaluate_function: DGConvFnBackward", 130, 150,
           corr=26, tid=AUTOGRAD, seq=3, fwd_tid=MAIN),
        rng("DGConvFnBackward", 130, 150, tid=AUTOGRAD, seq=3,
            fwd_tid=MAIN),
        rng("spconv.dgrad", 131, 140, tid=AUTOGRAD),
        op("spconv_tpu_torch::dg_gather_gemm", 132, 133, corr=27,
           tid=AUTOGRAD),
        dev("pow_bwd", 200, 201, linked=21),
        dev("where_bwd", 201, 203, linked=23),
        dev("mul_bwd", 203, 206, linked=25),
        dev("dgrad", 206, 210, linked=27),
    ]
    att = spans.attribute(events, calls=1)
    assert att.by_span == {"spconv.epilogue": 2.0, "spconv.bn": 3.0,
                           "spconv.dgrad": 4.0}
    assert att.outside == 1.0
    assert att.backward == 10.0 and att.backward_reached == 9.0
    assert att.summary()["backward_reached"] == 0.9


def test_gaps_split_by_the_port_ranges_open_at_their_start():
    """Idle gaps open inside a ``spconv.*`` span or a layer range are the
    port's; those in the caller's range around the forward (which holds
    ``spconv.bn`` directly, and the layers), in a torch backward node or
    after the last range are not.  A node range that directly holds
    ``spconv.dgrad`` is a layer range."""
    events = [
        rng("bench.forward", 0, 100),
        rng("SubMConv3d", 0, 30),
        rng("spconv.product", 5, 10),
        rng("spconv.bn", 30, 40),
        rng("SubMConv3d", 50, 80),
        rng("spconv.epilogue", 60, 70),
        rng("WhereBackward0", 200, 210, tid=AUTOGRAD),
        rng("DGConvFnBackward", 210, 230, tid=AUTOGRAD),
        rng("spconv.dgrad", 211, 215, tid=AUTOGRAD),
        # device busy intervals; a gap opens at the end of each
        dev("k", 0, 6), dev("k", 8, 20),     # gap 6-8: in spconv.product
        dev("k", 25, 33),                    # 20-25: SubMConv3d's own
        dev("k", 45, 52),                    # 33-45: in spconv.bn
        dev("k", 90, 95),                    # 52-90: SubMConv3d's, at 52
        dev("k", 120, 201),                  # 95-120: bench.forward only
        dev("k", 205, 212),                  # 201-205: WhereBackward0
        dev("k", 220, 240),                  # 212-220: spconv.dgrad
        dev("k", 300, 310),                  # 240-300: no range
    ]
    layers = {(e.name, e.start) for e in spans.port_ranges(
        [e for e in events if e.kind == "range"])}
    assert layers == {("SubMConv3d", 0), ("SubMConv3d", 50),
                      ("spconv.product", 5), ("spconv.bn", 30),
                      ("spconv.epilogue", 60), ("DGConvFnBackward", 210),
                      ("spconv.dgrad", 211)}
    att = spans.attribute(events, calls=2)
    assert att.gap_total == 2 + 5 + 12 + 38 + 25 + 4 + 8 + 60
    assert att.gap_port == 2 + 5 + 12 + 38 + 8
    assert att.port_gap_share == att.gap_port / att.gap_total


def test_nest_finds_the_innermost_interval():
    nest = spans.Nest([rng("a", 0, 100), rng("b", 10, 20),
                       rng("c", 12, 15), rng("d", 30, 40)])
    assert [getattr(nest.at(t), "name", None)
            for t in (5, 12, 16, 20, 35, 100)] == ["a", "c", "b", "a", "d",
                                                   None]


def _small_net_events(part):
    """``spans.from_kineto`` of a subm conv, BN and a backward of the
    port on the CPU, profiled by ``part``."""
    import numpy as np

    import spconv_tpu_torch as st

    coords = np.unique(np.random.RandomState(0).randint(0, 8, (60, 3)),
                       axis=0)
    n = coords.shape[0]
    inds = torch.from_numpy(np.concatenate(
        [np.zeros((n, 1)), coords], 1).astype(np.int32))
    x = st.SparseConvTensor(torch.randn(n, 4), inds, (8, 8, 8),
                            1).sort_by_key()
    conv = st.SubMConv3d(4, 8, 3, indice_key="s", device="cpu")
    bn = st.BatchNorm1d(8, device="cpu")
    with part() as prof:
        bn(conv(x)).features.pow(2).sum().backward()
    return spans.from_kineto(prof.kineto_results.events())


def test_cpu_profile_of_the_port_links_backward_to_bn():
    """On the CPU profiler's own events of a subm conv and BN: a stand-in
    device op for every host op, linked by correlation id, reaches
    ``spconv.bn`` from BN's backward nodes by sequence number, and
    ``spconv.dgrad`` / ``spconv.wgrad`` keep theirs."""
    events = _small_net_events(span_times._parts(cuda=False)[0])
    assert {"spconv.rulebook", "spconv.product", "spconv.epilogue",
            "spconv.bn", "spconv.dgrad", "spconv.wgrad"} <= {
                e.name for e in events if e.kind == "range"}
    assert any(e.backward for e in events)
    t = max(e.end for e in events) + 1
    stand_in = [dev(e.name, t + i, t + i + 1, linked=e.corr)
                for i, e in enumerate(e for e in events if e.kind == "op")]
    att = spans.attribute(events + stand_in, calls=1)
    assert att.by_span["spconv.bn"] > 0 and att.by_span["spconv.wgrad"] > 0
    assert att.by_span["spconv.dgrad"] > 0 and att.backward_reached > 0
    # BN alone takes an rsqrt: its backward node's ops reach spconv.bn
    rsqrt = [e for e in events if e.backward and e.name.endswith(
        "RsqrtBackward0")]
    assert rsqrt
    bn_bwd = [dev("k", t + i, t + i + 1, linked=e.corr)
              for i, e in enumerate(rsqrt)]
    att = spans.attribute(events + bn_bwd, calls=1)
    assert att.by_span == {"spconv.bn": float(len(bn_bwd))}
    assert att.backward == att.backward_reached == att.total


def test_ranges_part_keeps_ranges_and_nodes_and_no_op():
    """``span_times.py``'s ``ranges`` part records the port's spans and
    autograd's nodes and no host op; its ``full`` part records both."""
    full, ranges = span_times._parts(cuda=False)
    kept = _small_net_events(ranges)
    names = {e.name for e in kept if e.kind == "range"}
    assert {"spconv.rulebook", "spconv.product", "spconv.bn",
            "spconv.dgrad", "spconv.wgrad"} <= names
    assert any(e.backward for e in kept if e.kind == "range")
    assert not [e for e in kept if e.kind == "op" and e.name.startswith(
        "aten::")]
    assert [e for e in _small_net_events(full) if e.kind == "op"
            and e.name.startswith("aten::")]
    assert not torch.autograd.profiler._is_profiler_enabled


def test_span_times_rehearsal_opens_every_serving_span():
    """One seed of ``cp-serve-b16`` at the rehearsal size: the three parts
    run, the profiled ones open the serving path's spans, and with no
    device op every device number is 0."""
    row = span_times.one_seed(spec.load_cell("cp-serve-b16"), 3000000019,
                              torch.device("cpu"), rehearse=True, calls=1)
    assert set(row["ms"]) == {"plain", "full", "ranges"}
    assert {"spconv.rulebook", "spconv.product", "spconv.epilogue",
            "spconv.dense"} <= set(row["spans_opened"])
    assert row["attribution"]["total_ms"] == 0.0
    assert row["front_idle_pct"] == {"full": 0.0, "ranges": 0.0}
