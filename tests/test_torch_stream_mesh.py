"""The port's process mesh over streams (super_tpu_torch/parallel/: mesh,
multihost, make_multichip_step, MultiStreamPipeline with a mesh), on the
CPU with gloo process groups: tests/test_parallel.py's and
tests/test_multihost.py's multi-stream checks on the port.

The workers (tests/torch_parallel_worker.py, no JAX) start their world
through ``multihost.initialize`` with a file under the test's temporary
directory.  Two streams, test_parallel.py:test_multistream_pipeline's two
time windows of one generated sequence (the generator's seed varies only
the tracked pixels), on the port's main-path config:

- ('stream' 2, 'shard' 1), two processes: each stream is bitwise its
  single-stream track, since each process runs the same operations on
  the same inputs;
- ('stream' 2, 'shard' 2), four processes: each stream's LM solve is
  split over two processes, whose sums reassociate the single process's,
  so each stream is held to tests/torch_helpers.py:check_track's bands,
  and the two processes of a shard group to each other bitwise.

make_multichip_step runs captured, under the workers' stand-in of the
graphs cut at the all-reduces (tests/torch_parallel_worker.py:CutStandIn).
"""

import dataclasses

import numpy as np
import pytest

from torch_helpers import check_track, join_workers, same_bits, \
    slice_config, start_workers, write_inputs

STREAM_SEED = 2


# --- two stream processes ----------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The workers' inputs: the port's main-path config (the streams are
    generated by each worker)."""
    root = tmp_path_factory.mktemp("torch_stream_mesh")
    write_inputs(
        root,
        track_cfg=dataclasses.asdict(slice_config(gram_sum_dtype="bf16")),
        streams=[0, 1], stream_seed=STREAM_SEED)
    return root


@pytest.fixture(scope="module")
def stream_runs(root):
    return join_workers("streams", start_workers("streams", 2, root), root)


def test_stream_mesh_layout(stream_runs):
    for r, out in enumerate(stream_runs):
        assert out["mesh"] == [[0], [1]]
        assert out["coordinate"] == [r, 0]
        assert out["stream"] == r


def test_multichip_streams_are_the_single_stream_tracks(stream_runs):
    """Each rank's stream through shard_stream_batch and
    make_multichip_step is bitwise its single-stream track."""
    for out in stream_runs:
        same_bits(out["outs"], out["single_outs"])
        same_bits(out["state"], out["single_state"])


def test_one_shard_mesh_step_is_one_graph(stream_runs):
    """make_multichip_step of a one-shard mesh, captured (the workers'
    stand-in of the cut graph), cuts nowhere: its capture and each replay
    run the whole step as one graph; so does MultiStreamPipeline's, which
    runs eagerly on CPU tensors."""
    for out in stream_runs:
        assert out["cuts"] == [0] * 3
        loop, captured, cuts = out["pipe_loop"]
        assert loop == "eager" and captured
        assert cuts == [0] * len(cuts) and len(cuts) >= 2


def test_streams_differ(stream_runs):
    a, b = stream_runs
    assert not np.allclose(a["state"][0], b["state"][0])


def test_stream_pipeline_on_mesh_is_the_single_pipeline(stream_runs):
    """MultiStreamPipeline(mesh=...) tracks each rank's stream bitwise as
    SuPerPipeline does alone, tracked points and errors included."""
    for out in stream_runs:
        same_bits(out["pipe_state"], out["ref_state"])
        same_bits(out["pipe_track"], out["ref_track"])
        same_bits([out["pipe_errors"][t] for t in sorted(out["pipe_errors"])],
              [out["ref_errors"][t] for t in sorted(out["ref_errors"])])


def test_stream_pipeline_summary_covers_every_stream(stream_runs):
    from super_tpu_torch.utils import evaluation

    a, b = stream_runs
    means = [evaluation.summarize(o["ref_errors"])["reproj_mean"]
             for o in stream_runs]
    for out in stream_runs:
        m = out["summary"]
        assert set(m) == {"reproj_mean", "reproj_mean_worst_stream",
                          "p50_batch_ms", "aggregate_fps"}
        assert m["reproj_mean"] < 4.0, m
        np.testing.assert_allclose(m["reproj_mean"], np.mean(means),
                                   rtol=1e-12)
        np.testing.assert_allclose(m["reproj_mean_worst_stream"],
                                   np.max(means), rtol=1e-12)


# --- four processes: two streams of two shards -------------------------------

@pytest.fixture(scope="module")
def mesh4_runs(root):
    return join_workers("mesh4", start_workers("mesh4", 4, root), root)


def test_mesh4_layout(mesh4_runs):
    for r, out in enumerate(mesh4_runs):
        assert out["mesh"] == [[0, 1], [2, 3]]
        assert out["coordinate"] == [r // 2, r % 2]
        assert out["stream"] == r // 2


def test_mesh4_shard_pairs_agree_bitwise(mesh4_runs):
    for s in range(2):
        a, b = mesh4_runs[2 * s], mesh4_runs[2 * s + 1]
        same_bits(a["outs"], b["outs"])
        same_bits(a["state"], b["state"])
    assert not np.allclose(mesh4_runs[0]["state"][0],
                           mesh4_runs[2]["state"][0])


def test_mesh4_step_cuts_at_each_all_reduce(mesh4_runs):
    """Each process's captured step cuts at the 11 all-reduces of a
    deferred frame, at its capture and at each replay."""
    for out in mesh4_runs:
        assert out["cuts"] == [11] * 3


@pytest.mark.parametrize("stream", [0, 1])
def test_mesh4_streams_within_track_bands(mesh4_runs, stream):
    out = mesh4_runs[2 * stream]
    check_track((out["single_outs"], out["outs"], out["single_nodes"],
                 out["nodes"]))
