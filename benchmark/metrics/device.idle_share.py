"""Share of the stretch in which no operation runs on the card, %.  Moves
frames_per_s."""

from benchmark import stats


def read(st):
    return stats.idle_share([(s, e) for s, e, _ in st.device], st.lo, st.hi)
