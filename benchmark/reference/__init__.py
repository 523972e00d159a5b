"""The plain references that the benchmark holds the port to.

A configuration file names its reference with ``"reference": "<module>"``,
which is ``benchmark/reference/<module>.py`` (``tracker`` where the key is
absent); ``benchmark.spec.load_reference`` finds it, and
``benchmark.compare.reference_frame`` and ``benchmark.run.run_cell`` use
nothing else of it than this interface:

- ``covers(cfg) -> list[str]``: the reasons it cannot check ``cfg`` (the
  configuration's ``config``), each naming its keys; empty when it can.
  A run stops with them before the clip is built.
- ``preprocess(cfg, intr, depth, color, time, prec=REF) -> frame``: the
  frame's surfel candidates from the raw depth and colour.
- ``init(cfg, frame, prec) -> (surfels, graph)``: the frame-0 start.
- ``step(cfg, surfels, graph, track, frame, prec) -> (surfels, graph,
  track, added)``: one tracked frame from the state before it; ``added``,
  the slots its new surfels took.
- ``bind_and_read(cfg, surfels, frame, track, gt_xy, gt_valid) -> track``:
  the GT points bound and the tracked points read.
- ``fields(state, prec) -> dict``: a state of the program (a NamedTuple of
  tensors) as the reference's dict, floats in its precision.
- ``REF`` and ``CONTROL``: the precisions of the reference and of the
  control, the reference computed one precision step below the
  configuration's in the program's place.

Each is plain PyTorch, float64 by default, written from the configuration's
mathematics (SuPer's preprocessing, embedded-deformation graph, LM warp
solve, warp and surfel fusion): no kernel, no capture, no layout of the
port's.  It imports nothing of the port or of JAX, and takes nothing the
port made but its state before a frame, which it reads field by field.  A
module that differs in one stage imports :mod:`tracker` and passes its own
parts in (``tracker.step``'s ``problem``, the LM problem class).
"""
