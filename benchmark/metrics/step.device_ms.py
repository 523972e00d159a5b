"""Device time of a frame (a batch step): the union of the device's
operations in the stretch over its frames, ms.  Moves frames_per_s."""

from benchmark import trace


def read(st):
    return trace.busy_us(st) / st.frames / 1e3
