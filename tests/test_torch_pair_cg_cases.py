"""The plain versions of kernels K1 and K1b on the pair systems that test
how the cooperative kernel splits its work (``adversarial_pair_system``:
shuffled pairs with sinks between them, a hub node, duplicate pairs, J
below the number of SMs), each against the JAX package's reference
recurrence and, at a small size, its Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import close

from super_tpu.pallas_kernels import pcg as jpcg
from super_tpu_torch.core import lm as tlm
from super_tpu_torch.kernels import pcg as tpcg

# (J, P) of each system for the reference, then for the interpreted kernel.
SIZES = {"shuffled": ((48, 400), (24, 160)), "hub": ((48, 400), (24, 160)),
         "duplicates": ((48, 400), (24, 160)),
         "few_nodes": ((64, 512), (64, 256))}
VERSIONS = {"k1": (tpcg.pairs_cg_plain, lambda t: t),
            "k1b": (tpcg.pairs_cg_chunked_plain,
                    lambda t: t.to(torch.bfloat16).to(torch.float32))}


def _f32(t):
    # conftest turns on x64: keep the reference in f32 as the kernels run.
    return jnp.asarray(t.numpy(), jnp.float32) if t.is_floating_point() \
        else jnp.asarray(t.numpy())


def _args(case, j, p, seed):
    layout, acc, rhs, u, x0 = tlm.adversarial_pair_system(case, j, p, seed,
                                                          device="cpu")
    return tlm.pairs_band_system(layout, acc, rhs, u, j, x0)


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("case", tlm.PAIR_CASES)
def test_pair_cg_plain_on_adversarial_system(case, version, monkeypatch):
    plain, round_banks = VERSIONS[version]
    (j, p), (j_small, p_small) = SIZES[case]

    # Against _pairs_cg_ref on the (8, 128)-padded vectors, 32 iterations;
    # K1b's reference gets the bf16-rounded banks.
    blk, blkt, n1, n2, minv, b_fm, u, x0_fm = _args(case, j, p, 5)
    got = plain(blk, blkt, n1, n2, minv, b_fm, u, x0_fm, iterations=32)
    jp = -(-j // 128) * 128

    def pad(a, rows):
        return np.pad(a.numpy(), ((0, rows - a.shape[0]), (0, jp - a.shape[1])))

    ref = jpcg._pairs_cg_ref(
        _f32(round_banks(blk)), _f32(round_banks(blkt)), _f32(n1), _f32(n2),
        _f32(torch.as_tensor(pad(minv, 64))), _f32(torch.as_tensor(pad(b_fm, 8))),
        _f32(torch.as_tensor(pad(x0_fm, 8))), _f32(u), iterations=32)
    assert np.asarray(ref).dtype == np.float32
    # The same f32 recurrence on the same blocks, sums in other orders over
    # 32 iterations: 1e-5 of the solution's size.
    scale = float(np.abs(got.numpy()).max())
    close(np.asarray(ref)[:7, :j], got, atol=1e-5 * scale, name="ref")

    # Against the Pallas kernel itself, interpreted: the chunked one for
    # K1b, forced as test_pallas_pcg.py forces it.
    # (K1b's table is 8 pairs longer: jit would reuse K1's trace, which
    # read the threshold, for the same shapes.)
    args = _args(case, j_small, p_small + 8 * (version == "k1b"), 6)
    monkeypatch.setattr(jpcg, "_PAIRS_PERSISTENT_OH_MAX",
                        0 if version == "k1b" else 1 << 40)
    monkeypatch.setattr(jpcg, "_PAIRS_CHUNK", 128)
    want = jpcg.pairs_cg_pallas(*(_f32(t) for t in args), iterations=8,
                                interpret=True)
    got = plain(*args, iterations=8)
    # Gathers and scatters by one-hot products, sums in another order:
    # 1e-5 of the solution's size after 8 iterations.
    scale = float(np.abs(np.asarray(want)).max())
    close(want, got, atol=1e-5 * scale, name="kernel")
