"""The port's speed-of-light model and timing helpers (utils/sol.py,
utils/profiling.py) against the JAX package's.

With the port's constants set to the JAX package's values, the two
models are the same functions: stage_floors and sol_report must then
agree exactly for the headline's capacities.  With its own constants the
port's model must hold no TPU number.  The timing helpers run on the CPU
here (the card path is chip_smoke.py's ``sol`` phase)."""

import os

import pytest
import torch

import torch_helpers  # noqa: F401  (two threads)

from super_tpu.utils import sol as jsol
from super_tpu_torch.config import lm_workload_config
from super_tpu_torch.utils import profiling
from super_tpu_torch.utils import sol

# The port's constant for each of the JAX package's.
JAX_VALUES = dict(HBM_GBPS=jsol.HBM_GBPS, PEAK_TFLOPS=jsol.MXU_TFLOPS,
                  RAND_GATHER_GBPS=jsol.RAND_GATHER_GBPS,
                  GATHER_FIXED_MS=jsol.GATHER_FIXED_MS,
                  SCATTER_NS_PER_ELEM=jsol.SCATTER_NS_PER_ELEM,
                  SORT3_MS_PER_393K=jsol.SORT3_MS_PER_393K,
                  LAUNCH_MS=0.2)   # the JAX model's solve dispatch term


def _headline(mesh_step=30):
    cfg = lm_workload_config(480, 640, mesh_step)
    return dict(np_cap=cfg.capacity.surfel_capacity, p=cfg.image_pixels,
                j=cfg.capacity.node_capacity,
                t_cap=cfg.solver.assembly_tuple_cap,
                a_cap=cfg.capacity.new_surfel_capacity,
                pcg_iters=cfg.solver.pcg_iterations,
                num_lm_iters=cfg.solver.num_iterations)


@pytest.mark.parametrize("mesh_step", [30, 16])
def test_floors_and_report_match_jax(monkeypatch, mesh_step):
    for name, value in JAX_VALUES.items():
        monkeypatch.setattr(sol, name, value)
    caps = _headline(mesh_step)
    want = jsol.stage_floors(**caps)
    got = sol.stage_floors(**caps)
    assert got == want
    achieved = {"prepare": 3.1, "assoc": 0.4, "assemble": 0.07,
                "solve": 2.6, "fuse": 3.3, "unknown": 1.0, "step": 0.0}
    flops = {"assemble": caps["np_cap"] * 28 * 29 * 2}
    assert sol.sol_report(achieved, got, flops) == \
        jsol.sol_report(achieved, want, flops)


def test_own_constants_hold_no_tpu_number():
    """The v5e's 819 GB/s, 197 / 49 TFLOP/s, 1 ms gather floor, ~10 GB/s
    random gather, 5 ns scatter and 1.7 ms sort are not the port's; its
    streaming and arithmetic rates are chip_smoke.py's bound()'s."""
    for name, value in JAX_VALUES.items():
        assert getattr(sol, name) != value, name
    assert sol.HBM_GBPS * 1e9 == 3.35e12
    assert sol.PEAK_TFLOPS["f32"] * 1e12 == 67e12
    floors = sol.stage_floors(**_headline())
    assert all(0 < v < 10 for v in floors.values()), floors


def test_chain_time_and_loop_time():
    x = torch.rand(64, 64)
    calls = []

    def fn(a):
        calls.append(1)
        return (a @ a,)

    s = profiling.chain_time(fn, x, reps=3)
    assert s > 0 and len(calls) == 5       # two warm-up calls
    ms = profiling.loop_time(lambda acc, a: (a @ a).sum() + acc,
                             torch.zeros(()), n_iter=4, args=(x,))
    assert ms > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.rand(32, 32).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert profiling.kernel_spans(prof) == []   # no card here
