"""Self time of the frame loop's ``pipeline.frame`` spans (pipeline.py,
parallel/streams.py) per frame (batch step), ms: a root's time that none
of the program's spans inside it (``pipeline.*``, ``graph.*``) covers,
the loop's own glue and any host work that no span names.  None where the
stretch holds no ``pipeline.frame`` span (a program without the frame
loop's spans).  Moves frames_per_s."""

from benchmark import stats

ROOT = "pipeline.frame"
PREFIXES = ("pipeline.", "graph.")


def read(st):
    roots = [(s, e) for s, e, n in st.host if n == ROOT]
    if not roots:
        return None
    parts = [(s, e) for s, e, n in st.host
             if n.startswith(PREFIXES) and n != ROOT]
    total = 0.0
    for s, e in roots:
        lo, hi = max(s, st.lo), min(e, st.hi)
        if hi > lo:
            total += hi - lo - stats.union(parts, lo, hi)
    return total / st.frames / 1e3
