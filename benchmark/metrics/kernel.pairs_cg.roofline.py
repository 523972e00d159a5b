"""Kernel K1 (kernels/pcg.py, csrc/pairs_cg.cu), the pair-sparse CG of the
LM solve: the least time of its work in the stretch over its traced time,
%.  The work is one damped solve of the frame's problem an LM trip
(roofline.pairs_cg_work), counted from the tracker's state; the time sums
the device operations named below.  Moves frames_per_s."""

from benchmark import roofline

NAMES = ("pairs_cg_kernel",)


def read(st):
    solver = st.config.solver
    if not solver.use_derived_gradient:
        return None
    z = roofline.stretch_problem(st)
    work = roofline.pairs_cg_work(z["nodes"], z["pairs"],
                                  solver.pcg_iterations)
    return roofline.share(st, "kernel.pairs_cg.roofline",
                          lambda n: any(k in n for k in NAMES), work,
                          solver.num_iterations)
