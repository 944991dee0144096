"""The selective scan's backward on the CPU: the port's plain backward
(``ssm_scan_bwd_ref``), the router under autograd (``SSMScanFn``), and the
split ``csrc/ssm_scan.cu``'s backward kernel computes in, each against
autograd of the port's plain scan and ``jax.grad`` of the JAX package's
scans (``repro.kernels.ssm_scan.ref.ssm_scan_ref`` and
``repro.models.layers.mamba_scan_chunked``) on the same seeded inputs.

Tolerance: every gradient within 1e-5 of its largest magnitude (fp32
throughout; the orders of the sums differ).  dx of a bf16 x is bf16 on
both sides, each rounded once from fp32 sums that differ in their last
bits, so it is held within one bf16 step at the largest magnitude, 2^-7 of
it.  The kernel itself runs only on the card
(``tests/test_torch_kernels_card.py``).
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_ref  # noqa: E402
from repro.models.layers import mamba_scan_chunked as jax_chunked  # noqa: E402
from repro_torch.kernels.ssm_scan import (SSMScanFn, ssm_scan,  # noqa: E402
                                          ssm_scan_bwd, ssm_scan_bwd_ref,
                                          ssm_scan_ref)

TOL = 1e-5
BF16_STEP = 2.0 ** -7
N = 16
CHUNK = 16                  # steps a saved state covers (csrc CHUNK)
BWD_CH = 32                 # channels a backward block sums (csrc BWD_CH)
BWD_LANES = 4               # lanes a channel, 4 states each (csrc BWD_LANES)
LOG2E = np.float32(1.0 / math.log(2.0))
NAMES = ("dx", "ddt", "dBm", "dCm", "dA")


def _inputs(B, S, DI, dtype, dh, seed=3):
    """Standard-normal x, B, C and dy, softplus dt, A = -(1 .. 16) scaled
    per channel (Mamba-1's S4D-real start), and a random or no dh_final."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, DI), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, DI)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N), np.float32) for _ in range(2))
    A = (-np.arange(1, N + 1, dtype=np.float32)[None, :]
         * rng.uniform(0.5, 2.0, (DI, 1)).astype(np.float32))
    dy = rng.standard_normal((B, S, DI), np.float32)
    dhf = rng.standard_normal((B, DI, N), np.float32) if dh else None
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    rest = tuple(torch.from_numpy(a) for a in (dt, Bm, Cm, A, dy))
    return (xt,) + rest + (None if dhf is None else torch.from_numpy(dhf),)


def _held(got, want, dtype="float32", name=""):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, name
    mag = want.abs().max().item() if want.numel() else 0.0
    err = (got - want).abs().max().item() if want.numel() else 0.0
    tol = (BF16_STEP if dtype == "bfloat16" and name == "dx" else TOL) * mag
    assert err <= tol, f"{name}: {err} > {tol}"


@functools.lru_cache(maxsize=None)
def _jax_grads(B, S, DI, dtype, dh, which):
    """jax.grad of <y, dy> + <h_final, dh_final> through one of the JAX
    package's scans, on the same values (bf16 x as torch rounded it)."""
    x, dt, Bm, Cm, A, dy, dhf = _inputs(B, S, DI, dtype, dh)
    xj = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    args = (xj,) + tuple(jnp.asarray(t.numpy()) for t in (dt, Bm, Cm, A))
    dyj = jnp.asarray(dy.numpy())
    dhj = (jnp.zeros((B, DI, N), jnp.float32) if dhf is None
           else jnp.asarray(dhf.numpy()))
    scan = jax_ssm_ref if which == "ref" else jax_chunked

    def loss(*a):
        y, h = scan(*a)
        return jnp.sum(y * dyj) + jnp.sum(h * dhj)

    grads = jax.grad(loss, argnums=tuple(range(5)))(*args)
    return tuple(torch.from_numpy(np.array(g.astype(jnp.float32)))
                 for g in grads)


# (B, S, DI): one step, a step past a 16-step chunk, four chunks; DI 37 is
# a multiple of no tile (32 channels, 16-byte pieces)
SHAPES = [(2, 1, 37), (2, 17, 37), (1, 64, 37)]
GRAD_CASES = [(*s, dtype, dh) for s in SHAPES
              for dtype in ("float32", "bfloat16") for dh in (False, True)]


def _case_id(c):
    return "B{}S{}DI{}_{}_{}".format(*c[:4], "dh" if c[4] else "nodh")


@pytest.mark.parametrize("case", GRAD_CASES, ids=_case_id)
def test_plain_backward_matches_autograd_of_the_plain_scan(case):
    B, S, DI, dtype, dh = case
    x, dt, Bm, Cm, A, dy, dhf = _inputs(*case)
    got = ssm_scan_bwd_ref(x, dt, Bm, Cm, A, dy, dhf)
    assert got[0].dtype == x.dtype
    assert all(g.dtype == torch.float32 for g in got[1:])
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, Bm, Cm, A)]
    y, h = ssm_scan_ref(*leaves)
    outs, grads = (y, h), (dy, dhf if dhf is not None else torch.zeros_like(h))
    want = torch.autograd.grad(outs, leaves, grads)
    for name, g, w in zip(NAMES, got, want):
        _held(g, w, dtype, name)


@pytest.mark.parametrize("which", ["ref", "chunked"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=_case_id)
def test_plain_backward_matches_jax_grad_of_the_reference_scans(case, which):
    B, S, DI, dtype, dh = case
    x, dt, Bm, Cm, A, dy, dhf = _inputs(*case)
    got = ssm_scan_bwd_ref(x, dt, Bm, Cm, A, dy, dhf)
    want = _jax_grads(B, S, DI, dtype, dh, which)
    for name, g, w in zip(NAMES, got, want):
        _held(g, w, dtype, name)


# ------------------------------------------------------------- the router --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_under_autograd_goes_through_the_function(dtype):
    """On CPU tensors under autograd: SSMScanFn, whose backward is the
    plain backward on the same inputs, bit for bit; without autograd, no
    graph."""
    x, dt, Bm, Cm, A, dy, dhf = _inputs(2, 20, 24, dtype, True)
    leaves = [t.clone().requires_grad_() for t in (x, dt, Bm, Cm, A)]
    y, h = ssm_scan(*leaves)
    assert type(y.grad_fn).__name__ == "SSMScanFnBackward"
    assert y.grad_fn is h.grad_fn
    grads = torch.autograd.grad((y, h), leaves, (dy, dhf))
    want = ssm_scan_bwd_ref(x, dt, Bm, Cm, A, dy, dhf)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    ref_y, ref_h = ssm_scan_ref(x, dt, Bm, Cm, A)
    assert torch.equal(y.detach(), ref_y) and torch.equal(h.detach(), ref_h)
    with torch.no_grad():
        assert ssm_scan(*leaves)[0].grad_fn is None
    assert SSMScanFn is not None


def test_scan_gradient_through_one_output_alone():
    """y alone (the model drops h_final) and h_final alone: the missing
    output's gradient counts as zero."""
    x, dt, Bm, Cm, A, dy, dhf = _inputs(1, 19, 10, "float32", True)
    zero_dy, zero_dh = torch.zeros_like(dy), torch.zeros_like(dhf)
    for use_y, gy, gh in ((True, dy, zero_dh), (False, zero_dy, dhf)):
        leaves = [t.clone().requires_grad_() for t in (x, dt, Bm, Cm, A)]
        y, h = ssm_scan(*leaves)
        loss = (y * dy).sum() if use_y else (h * dhf).sum()
        grads = torch.autograd.grad(loss, leaves)
        want = ssm_scan_bwd_ref(x, dt, Bm, Cm, A, gy, gh)
        for name, g, w in zip(NAMES, grads, want):
            _held(g, w, "float32", name)


def test_backward_router_takes_the_plain_version_on_the_cpu():
    x, dt, Bm, Cm, A, dy, dhf = _inputs(2, 9, 11, "float32", True)
    got = ssm_scan_bwd(x, dt, Bm, Cm, A, dy, dhf)
    want = ssm_scan_bwd_ref(x, dt, Bm, Cm, A, dy, dhf)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------- the kernel's split --
def _slot_order(DI):
    """(DI, 16) state indices in the order the kernel's lanes hold them:
    lane k of channel d holds states 4k + (r ^ p) in its slots r = 0 .. 3,
    with p = (d % BWD_CH >> 1) & 3, its lane bits 4 and 3."""
    p = (torch.arange(DI) % BWD_CH >> 1) & 3
    r = torch.arange(N) % 4
    return (torch.arange(N) - r)[None, :] + (r[None, :] ^ p[:, None])


def _lane_sums(v):
    """Sum over the 16 states (last axis; channels on the one before) in the
    kernel's order: each of a channel's 4 lanes adds its 4 slots in turn,
    then the reduce-scatter over the lanes adds lanes l and l + 2, then the
    two pairs: (L0 + L2) + (L1 + L3)."""
    v = torch.gather(v, -1, _slot_order(v.shape[-2]).expand_as(v))
    lanes = [v[..., 4 * k] for k in range(BWD_LANES)]
    for k in range(BWD_LANES):
        for j in range(1, 4):
            lanes[k] = lanes[k] + v[..., 4 * k + j]
    return (lanes[0] + lanes[2]) + (lanes[1] + lanes[3])


def _block_sums(red):
    """Sum the terms over each block's BWD_CH channels (axis -2) in the
    kernel's order: a warp's 8 channels by its reduce-scatter over lane bits
    4, 3 and 2, ((c0 + c4) + (c2 + c6)) + ((c1 + c5) + (c3 + c7)), then the
    block's warps in order."""
    *lead, nblk, _, n = red.shape
    w = red.reshape(*lead, nblk, BWD_CH // 8, 8, n)
    p = w[..., :4, :] + w[..., 4:, :]               # channels c and c + 4
    p = p[..., :2, :] + p[..., 2:, :]               # then c and c + 2
    warp = p[..., 0, :] + p[..., 1, :]              # then c and c + 1
    total = warp[..., 0, :]
    for k in range(1, BWD_CH // 8):
        total = total + warp[..., k, :]
    return total


def kernel_split_bwd(x, dt, Bm, Cm, A, dy, dhf):
    """The backward kernel's arithmetic in plain torch: the forward saves
    the state entering every CHUNK steps; the chunks run in reverse, each
    recomputing its states from the saved one with exp as 2^(dt (A log2 e));
    dx and ddt sum over n in the lanes' order (``_lane_sums``); dB and dC
    are summed over each block's BWD_CH channels in the warps' and the
    block's order (``_block_sums``), then over the blocks in order; dA over
    time within a batch row, then over the rows in order."""
    Bsz, S, DI = x.shape
    xf, dtf, Bf, Cf, Af, dyf = (t.float() for t in (x, dt, Bm, Cm, A, dy))
    a2 = Af * float(LOG2E)
    nc = -(-S // CHUNK)
    h = torch.zeros((Bsz, DI, N))
    states = []
    for t in range(S):
        if t % CHUNK == 0:
            states.append(h)
        h = (h * torch.exp2(dtf[:, t, :, None] * a2)
             + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
    assert len(states) == nc
    G = torch.zeros((Bsz, DI, N)) if dhf is None else dhf.clone()
    dA_row = torch.zeros((Bsz, DI, N))
    dx = torch.zeros((Bsz, S, DI))
    ddt = torch.zeros((Bsz, S, DI))
    nblk = -(-DI // BWD_CH)
    red = torch.zeros((2, Bsz, S, nblk * BWD_CH, N))   # dB's, dC's terms
    for ci in reversed(range(nc)):
        t0, t1 = ci * CHUNK, min(S, (ci + 1) * CHUNK)
        hh, es = [states[ci]], []
        for t in range(t0, t1):
            es.append(torch.exp2(dtf[:, t, :, None] * a2))
            hh.append(hh[-1] * es[-1]
                      + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :])
            red[1, :, t, :DI] = dyf[:, t, :, None] * hh[-1]
        for t in reversed(range(t0, t1)):
            k = t - t0
            g = Cf[:, t, None, :] * dyf[:, t, :, None] + G
            ge = g * es[k]
            q = ge * hh[k]
            s1 = _lane_sums(g * Bf[:, t, None, :])
            dx[:, t] = dtf[:, t] * s1
            ddt[:, t] = xf[:, t] * s1 + _lane_sums(Af * q)
            dA_row = dA_row + dtf[:, t, :, None] * q
            red[0, :, t, :DI] = g * (dtf[:, t] * xf[:, t])[..., None]
            G = ge
    part = _block_sums(red.reshape(2, Bsz, S, nblk, BWD_CH, N))
    sums = torch.zeros((2, Bsz, S, N))
    for blk in range(nblk):                     # the blocks in order
        sums = sums + part[:, :, :, blk]
    dA = torch.zeros((DI, N))
    for b in range(Bsz):                        # the batch rows in order
        dA = dA + dA_row[b]
    return dx.to(x.dtype), ddt, sums[0], sums[1], dA


# (B, S, DI, x dtype, dh_final): the 1100-token prompt hymba-1.5b prefills
# at a narrow d_inner, S and DI off the chunks and the 32-channel blocks,
# one step, several whole blocks of channels, a DI that ends inside a
# warp's 8 channels of the second block with S off the chunks, and nine
# whole blocks and part of a tenth
SPLIT_CASES = [(2, 1100, 40, "float32", True), (2, 1100, 40, "bfloat16", False),
               (3, 33, 130, "float32", False), (3, 33, 130, "bfloat16", True),
               (1, 1, 7, "float32", True), (2, 48, 96, "float32", False),
               (2, 70, 45, "bfloat16", True), (1, 20, 300, "float32", True)]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=_case_id)
def test_kernel_split_matches_plain_backward_and_jax(case):
    B, S, DI, dtype, dh = case
    x, dt, Bm, Cm, A, dy, dhf = _inputs(*case)
    got = kernel_split_bwd(x, dt, Bm, Cm, A, dy, dhf)
    plain = ssm_scan_bwd_ref(x, dt, Bm, Cm, A, dy, dhf)
    for name, g, w in zip(NAMES, got, plain):
        _held(g, w, dtype, name)
    if S <= 64:             # the JAX scans compile per shape: the short ones
        for name, g, w in zip(NAMES, got,
                              _jax_grads(B, S, DI, dtype, dh, "chunked")):
            _held(g, w, dtype, name)
