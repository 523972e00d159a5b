"""Kernel K2's ``data_gram`` form (kernels/gram.py, csrc/tuple_gram.cu),
the point-plane term's rows and per-tuple Grams: the least time of its work
in the stretch over its traced time, %.  The work is one assembly of the
frame's problem an LM trip (roofline.data_gram_work), counted from the
tracker's state; the time sums the device operations named below (the
template's data-term instance).  Moves frames_per_s."""

from benchmark import roofline

NAMES = ("gram_kernel",)
SOURCE = "Data"


def read(st):
    solver = st.config.solver
    if not solver.use_derived_gradient:
        return None
    z = roofline.stretch_problem(st)
    work = roofline.data_gram_work(z["slots"], z["rows"], z["tuples"])
    return roofline.share(
        st, "kernel.data_gram.roofline",
        lambda n: SOURCE in n and any(k in n for k in NAMES), work,
        solver.num_iterations)
