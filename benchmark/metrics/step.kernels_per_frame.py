"""Kernels the card ran in the stretch (copies and fills left out) per
frame (batch step).  A count: it repeats exactly.  Moves frames_per_s."""

from benchmark import trace


def read(st):
    n = sum(1 for s, _, name in st.device
            if st.lo <= s < st.hi and trace.is_kernel(name))
    return n / st.frames
