"""Host time of a frame (a batch step) in the frame loop (pipeline.py,
parallel/streams.py): the stretch's wall time less the host's time in
calls that wait for the card (synchronisations, copies to the host), per
frame, in ms.  Moves frames_per_s."""

from benchmark import trace


def read(st):
    return (st.hi - st.lo - trace.wait_us(st)) / st.frames / 1e3
