"""Host time of a frame (a batch step) in the frame loop's
``pipeline.gt_binding`` spans (pipeline.py, parallel/streams.py): the GT
points bound to surfels, enqueued on the card (core/track_points.py), per
frame, ms; None where the stretch holds no ``pipeline.frame`` span (a
program without the frame loop's spans).  Moves frames_per_s."""

NAMES = ("pipeline.gt_binding",)


def read(st):
    if not any(n == "pipeline.frame" for _, _, n in st.host):
        return None
    total = sum(max(0.0, min(e, st.hi) - max(s, st.lo))
                for s, e, n in st.host if n in NAMES)
    return total / st.frames / 1e3
