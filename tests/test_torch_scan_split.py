"""The lane split behind the port's selective-scan kernel, on the CPU.

``csrc/ssm_scan.cu`` splits each channel's 16 states over 2 or 8
neighbouring lanes of a warp (2 at hymba's prefill, 8 at the 1100-token
prompt): each lane updates its states with exp(dt * A) = 2^(dt * (A log2
e)) and forms its partial dot product with C_t, and every `lanes` steps the
lanes' partials are summed by a reduce-scatter over the lanes, halves
first: y = ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)) at 8 lanes.  These tests emulate that
order in plain torch and hold it to the port's plain
version, to the JAX package's reference and to its Pallas kernel in
interpret mode, at the 1100-token prompt hymba-1.5b's generate path
prefills (at a narrow d_inner) and at S and DI off the kernel's 16-step
chunks and 32-channel blocks, on seeded inputs.  The kernel itself runs
only on the card (``tests/test_torch_kernels_card.py``).
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_ref  # noqa: E402
from repro.kernels.ssm_scan.ssm_scan import ssm_scan_pallas  # noqa: E402
from repro_torch.kernels.ssm_scan import scan_lanes, ssm_scan_ref  # noqa: E402

TOL = 1e-5                  # of the largest magnitude, as the LM kernel tests
LOG2E = np.float32(1.0 / math.log(2.0))
# (B, S, DI, lanes, x dtype): the 1100-token prompt at a narrow d_inner
# with the 8 lanes the kernel takes there, in both x dtypes, and with the 2
# hymba's prefill takes; then S and DI off the 16-step chunks and the
# blocks' channels, in each split
CASES = [(2, 1100, 40, 8, "float32"), (2, 1100, 40, 8, "bfloat16"),
         (2, 1100, 40, 2, "float32"), (3, 33, 130, 8, "float32"),
         (3, 33, 130, 2, "bfloat16"), (1, 1, 7, 8, "float32")]


def lane_split_scan(x, dt, Bm, Cm, A, lanes):
    """The kernel's order: fp32 throughout, exp as 2^(dt * (A log2 e)), a
    lane's N / lanes states summed in order, then the lanes' partials in
    halves, as the reduce-scatter sums them."""
    Bsz, S, DI = x.shape
    N = Bm.shape[-1]
    xf, dtf = x.float(), dt.float()
    a2 = A.float() * float(LOG2E)                    # (DI, N), rounded once
    h = torch.zeros((Bsz, DI, N), dtype=torch.float32)
    ys = []
    for t in range(S):
        dt_t = dtf[:, t]
        h = (h * torch.exp2(dt_t[..., None] * a2)
             + (dt_t * xf[:, t])[..., None] * Bm[:, t, None, :])
        prod = (h * Cm[:, t, None, :]).reshape(Bsz, DI, lanes, N // lanes)
        part = prod[..., 0]
        for j in range(1, N // lanes):              # one lane's states
            part = part + prod[..., j]
        while part.shape[-1] > 1:                   # lanes l and l + n / 2
            half = part.shape[-1] // 2
            part = part[..., :half] + part[..., half:]
        ys.append(part[..., 0])
    return torch.stack(ys, dim=1), h


@functools.lru_cache(maxsize=None)
def _inputs(B, S, DI, dtype):
    """As ``chip_smoke.ssm_case``: standard-normal x, B and C, softplus dt,
    A = -(1 .. 16) in every channel (Mamba-1's S4D-real start)."""
    N = 16
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, DI), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, DI)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N), np.float32) for _ in range(2))
    A = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (DI, N)).copy()
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    # the JAX side reads the same values: bf16 x as rounded by torch
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    args = (xj,) + tuple(jnp.asarray(a) for a in (dt, Bm, Cm, A))
    # the Pallas kernel takes whole chunks and channel blocks
    chunk = 100 if S % 100 == 0 else S
    refs = (jax_ssm_ref(*args),
            ssm_scan_pallas(*args, chunk=chunk, block_di=DI, interpret=True))
    refs = tuple((torch.from_numpy(np.array(y)), torch.from_numpy(np.array(h)))
                 for y, h in refs)
    return (xt,) + tuple(torch.from_numpy(a) for a in (dt, Bm, Cm, A)), refs


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "B{}S{}DI{}lanes{}_{}".format(*c))
def test_lane_split_matches_plain_jax_ref_and_pallas(case):
    B, S, DI, lanes, dtype = case
    args, refs = _inputs(B, S, DI, dtype)
    y, h = lane_split_scan(*args, lanes=lanes)
    plain = ssm_scan_ref(*args)
    for want_y, want_h in (plain,) + refs:
        assert _rel(y, want_y) <= TOL
        assert _rel(h, want_h) <= TOL


# (B, DI) -> lanes on a 132-SM card: 2 where a grid of B x DI / 64 blocks
# gives every SM four, else 8.  hymba-1.5b's prefill takes 2 (800 blocks);
# B 11 is the first batch to (550); the 1100-token prompt at B 2 and small
# scans take 8.
LANES = [((16, 3200), 2), ((11, 3200), 2), ((10, 3200), 8), ((2, 3200), 8),
         ((2, 200), 8), ((1, 7), 8)]


@pytest.mark.parametrize("shape,lanes", LANES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_scan_lanes_fill_the_card(shape, lanes):
    assert scan_lanes(*shape, sms=132) == lanes
