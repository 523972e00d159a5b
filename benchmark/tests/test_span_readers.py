"""The readers of the frame loop's program spans (benchmark/metrics/
pipeline.{copy_in,launch,binding,wait,unspanned}_ms.py) on made-up spans:
known values, spans that cross the stretch's ends clipped to it, and None
on a stretch with no ``pipeline.frame`` span (a program without the
spans)."""

import pytest

from benchmark import spec
from benchmark import trace as tr

# Two frames in [0, 100] us; the first root starts before the stretch and
# the last ends after it.  Inside each root: its parts (some under the
# harness's own ``bench.*`` wrappers), CUDA runtime calls and an aten op.
HOST = [
    (-10, 48, "pipeline.frame"),
    (-10, 2, "pipeline.fetch"),                       # 2 in the stretch
    (3, 12, "pipeline.preprocess"),
    (3, 12, "bench.preprocess"),
    (3, 5, "graph.load"),
    (5, 9, "graph.run"),
    (6, 8, "cudaGraphLaunch"),
    (9, 11, "graph.copy_out"),
    (13, 30, "pipeline.step"),
    (13, 30, "bench.step"),
    (13, 14, "graph.load"),
    (14, 25, "graph.run"),
    (25, 29, "graph.copy_out"),
    (31, 40, "bench.gt_binding"),
    (31, 36, "pipeline.gt_binding"),
    (32, 33, "aten::bitwise_and"),
    (36, 40, "pipeline.read"),
    (37, 39, "cudaMemcpyAsync"),
    (41, 45, "pipeline.sync"),
    (46, 48, "pipeline.read"),
    (50, 130, "pipeline.frame"),
    (50, 60, "pipeline.fetch"),
    (60, 70, "pipeline.preprocess"),
    (61, 63, "graph.load"),
    (63, 66, "graph.run"),
    (66, 69, "graph.copy_out"),
    (70, 90, "pipeline.step"),
    (71, 73, "graph.load"),
    (73, 95, "graph.run"),          # ends past its parent: a union
    (95, 97, "graph.copy_out"),
    (97, 110, "pipeline.gt_binding"),                 # 3 in the stretch
    (110, 120, "pipeline.read"),                      # past the stretch
]
# Over the two frames, in us: graph.load 2+1+2+2, graph.run 4+11+3+22,
# gt_binding 5+3, read and sync 4+4+2; the roots' self time: frame 1 in
# [0, 48] less its parts' union [0, 2] [3, 12] [13, 30] [31, 40] [41, 45]
# [46, 48], 48 - 43 = 5; frame 2 in [50, 100], covered ([90, 95] by
# graph.run, which outlasts pipeline.step): 0.
WANT = {"pipeline.copy_in_ms": 7 / 2e3, "pipeline.launch_ms": 40 / 2e3,
        "pipeline.binding_ms": 8 / 2e3, "pipeline.wait_ms": 10 / 2e3,
        "pipeline.unspanned_ms": 5 / 2e3}


def stretch(host):
    return tr.Stretch(lo=0.0, hi=100.0, frames=2,
                      device=[(0, 10, "k_a"), (40, 60, "k_b")], host=host,
                      streams=1, states=[], config=None, intr=None,
                      context={})


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_on_made_up_spans(name):
    reader = spec.load_metric(name)
    assert reader.read(stretch(HOST)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_give_none_without_frame_spans(name):
    reader = spec.load_metric(name)
    parent = [h for h in HOST if not h[2].startswith(("pipeline.",
                                                      "graph."))]
    assert reader.read(stretch(parent)) is None
    # Spans of the parts alone, with no root, read None too.
    rootless = [h for h in HOST if h[2] != "pipeline.frame"]
    assert reader.read(stretch(rootless)) is None


def test_unspanned_counts_a_gap_no_part_covers():
    reader = spec.load_metric("pipeline.unspanned_ms")
    host = [(0, 100, "pipeline.frame"), (10, 20, "pipeline.fetch"),
            (15, 18, "graph.load"), (30, 60, "pipeline.step"),
            (40, 50, "aten::add")]
    st = stretch(host)._replace(frames=1)
    assert reader.read(st) == pytest.approx((100 - 10 - 30) / 1e3)
