"""Tiny tracks with the LM step's options and fusion's scatter maps, the
port against the JAX package, as tests/test_torch_solvers.py holds the "pcg_pallas" track:
3 frames after frame 0 with damping hypotheses (H = 3 under pairs_fused,
H = 2 under pcg_pallas), the bf16 dense matrix and PCG, the scatter
assembly, the block expansion, and fusion's scatter projection maps."""

import pytest

from torch_helpers import check_track, option_tracks

# (solver fields, config fields)
OPTIONS = {
    "hypotheses": (dict(lm_hypotheses=3), None),
    "hypotheses_dense": (dict(linear_solver="pcg_pallas", lm_hypotheses=2),
                         None),
    "bf16_pcg": (dict(linear_solver="pcg", jtj_dtype="bf16"), None),
    "scatter": (dict(assembly_mode="scatter", linear_solver="cholesky"),
                None),
    "expand_blocks": (dict(assembly_expand="scatter",
                           linear_solver="cholesky"), None),
    "proj_map_scatter": ({}, dict(proj_map_mode="scatter")),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_track(option):
    check_track(option_tracks(*OPTIONS[option]))
