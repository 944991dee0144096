"""The LM path's kernels against the JAX reference kernels, on the CPU.

On the CPU each router (``rmsnorm``, ``ssm_scan``, ``flash_decode``) takes
the kernel's plain PyTorch version; it is held against the reference's
``ref.py`` and its Pallas kernel run in interpret mode, on the same numpy
inputs.  The CUDA kernels are held against these plain versions on the card
in ``test_torch_kernels_card.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_decode.flash_decode import \
    flash_decode_pallas  # noqa: E402
from repro.kernels.flash_decode.ref import \
    decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro.kernels.rmsnorm.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_ref  # noqa: E402
from repro.kernels.ssm_scan.ssm_scan import ssm_scan_pallas  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread each, so parallel test workers do
    not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def as_jax(x, dtype="float32"):
    return jnp.asarray(x, getattr(jnp, dtype))


def as_torch(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def to_np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_rel(got, want, rel):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


# --------------------------------------------------------------- rmsnorm --
def bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 96), (7, 1600), (3, 77)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rmsnorm_plain_matches_jax_ref_and_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    x = rand(rng, *shape) * 3
    scale = 1 + 0.1 * rand(rng, shape[-1])
    got = to_np(rmsnorm(as_torch(x, dtype), as_torch(scale), 1e-5))
    for want in (jax_rmsnorm_ref(as_jax(x, dtype), as_jax(scale), 1e-5),
                 rmsnorm_pallas(as_jax(x, dtype), as_jax(scale), 1e-5,
                                block_rows=4, interpret=True)):
        want = to_np(want)
        if dtype == "float32":
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        else:            # both round one fp32 value: at most one bf16 ulp
            assert (np.abs(got - want) <= bf16_ulp(want)).all()


def test_rmsnorm_keeps_dtype_and_shape():
    x = torch.randn(2, 3, 16, generator=torch.Generator().manual_seed(0))
    out = rmsnorm(x.bfloat16(), torch.ones(16))
    assert out.dtype == torch.bfloat16 and out.shape == x.shape


# -------------------------------------------------------------- ssm_scan --
def ssm_inputs(B, S, DI, N, seed=1):
    rng = np.random.default_rng(seed)
    x = rand(rng, B, S, DI)
    dt = np.log1p(np.exp(rand(rng, B, S, DI))).astype(np.float32)  # softplus
    Bm, Cm = rand(rng, B, S, N), rand(rng, B, S, N)
    A = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (DI, N)).copy()
    return x, dt, Bm, Cm, A


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_plain_matches_jax_ref_and_pallas(dtype):
    x, dt, Bm, Cm, A = ssm_inputs(2, 32, 64, 16)
    y, h = ssm_scan(as_torch(x, dtype), *(as_torch(a) for a in (dt, Bm, Cm, A)))
    assert y.dtype == h.dtype == torch.float32
    args = (as_jax(x, dtype),) + tuple(as_jax(a) for a in (dt, Bm, Cm, A))
    for want_y, want_h in (jax_ssm_ref(*args),
                           ssm_scan_pallas(*args, chunk=8, block_di=32,
                                           interpret=True)):
        assert_rel(y, want_y, 1e-5)
        assert_rel(h, want_h, 1e-5)


@pytest.mark.parametrize("shape", [(1, 8, 3200, 16), (2, 7, 130, 16)],
                         ids=["DI3200", "S7DI130"])
def test_ssm_scan_plain_matches_jax_ref_off_the_pallas_tiles(shape):
    """hymba's d_inner (3200 is no multiple of the Pallas kernel's 512
    block) and shapes that fit no tile: against the reference's ref.py."""
    x, dt, Bm, Cm, A = ssm_inputs(*shape)
    y, h = ssm_scan(*(as_torch(a) for a in (x, dt, Bm, Cm, A)))
    want_y, want_h = jax_ssm_ref(*(as_jax(a) for a in (x, dt, Bm, Cm, A)))
    assert_rel(y, want_y, 1e-5)
    assert_rel(h, want_h, 1e-5)


# ---------------------------------------------------------- flash_decode --
def ring_kpos(Sc, pos):
    """Slot positions after positions 0..pos were written into a ring of Sc
    slots (slot = position % Sc); unwritten slots are -1."""
    kpos = np.full(Sc, -1, np.int32)
    for p in range(max(0, pos - Sc + 1), pos + 1):
        kpos[p % Sc] = p
    return kpos


# (B, KV, G, hd, Sc, pos, window): G = 5 as in hymba; a wrapped ring under a
# window narrower than the ring; empty slots; no window
FD_CASES = [(2, 2, 5, 32, 40, 57, 24), (2, 1, 5, 16, 40, 17, 0),
            (3, 2, 2, 32, 16, 100, 16)]


@pytest.mark.parametrize("case", FD_CASES, ids=lambda c:
                         "B{}KV{}G{}hd{}Sc{}pos{}w{}".format(*c))
def test_flash_decode_plain_matches_jax_ref_and_pallas(case):
    B, KV, G, hd, Sc, pos, window = case
    rng = np.random.default_rng(2)
    q, k, v = rand(rng, B, KV, G, hd), rand(rng, B, Sc, KV, hd), \
        rand(rng, B, Sc, KV, hd)
    kpos = ring_kpos(Sc, pos)
    got = flash_decode(as_torch(q), as_torch(k), as_torch(v),
                       torch.from_numpy(kpos), pos, window=window)
    jargs = (as_jax(q), as_jax(k), as_jax(v), jnp.asarray(kpos))
    for want in (jax_decode_ref(*jargs, pos, window=window),
                 flash_decode_pallas(*jargs, pos, window=window, block_k=16,
                                     interpret=True)):
        assert_rel(got, want, 1e-5)


def test_flash_decode_row_with_no_valid_slot_is_zeros():
    rng = np.random.default_rng(3)
    q, k = rand(rng, 1, 1, 5, 16), rand(rng, 1, 8, 1, 16)
    kpos = np.full(8, -1, np.int32)
    got = flash_decode(as_torch(q), as_torch(k), as_torch(k),
                       torch.from_numpy(kpos), 3)
    want = jax_decode_ref(as_jax(q), as_jax(k), as_jax(k), jnp.asarray(kpos), 3)
    assert (got == 0).all() and (np.asarray(want) == 0).all()


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_attn_decode_matches_jax_with_a_bf16_query(cache_dtype):
    """The LM's decode read with bf16 activations and a float cache: k is
    rounded to bf16 before the dot and the weights to the cache's type
    before the sum, in both packages."""
    jc, tc = (get("hymba-1.5b").smoke() for get in (jax_get_config,
                                                     get_config))
    rng = np.random.default_rng(4)
    D, KV, hd, Sc, pos = tc.d_model, tc.num_kv_heads, tc.resolved_head_dim, \
        16, 37
    p = {name: rand(rng, *shape) / np.sqrt(shape[0]) for name, shape in
         (("wq", (D, tc.num_heads * hd)), ("wk", (D, KV * hd)),
          ("wv", (D, KV * hd)), ("wo", (tc.num_heads * hd, D)))}
    x1 = rand(rng, 2, 1, D)
    ck, cv = rand(rng, 2, Sc, KV, hd), rand(rng, 2, Sc, KV, hd)
    kpos = ring_kpos(Sc, pos)                 # already holds pos
    want = jL.attn_decode({n: as_jax(w) for n, w in p.items()}, jc,
                          as_jax(x1, "bfloat16"), jnp.int32(pos),
                          as_jax(ck, cache_dtype), as_jax(cv, cache_dtype),
                          jnp.asarray(kpos))
    tk, tv = as_torch(ck, cache_dtype), as_torch(cv, cache_dtype)
    got = L.attn_decode({n: as_torch(w) for n, w in p.items()}, tc,
                        as_torch(x1, "bfloat16"), pos, tk, tv,
                        torch.from_numpy(kpos))
    assert got[0].dtype == torch.bfloat16
    assert_rel(got[0], want[0], 2e-2)             # y, one bf16 rounding apart
    # the new token's k and v went into its slot, in place
    for g, w, t in ((got[1], want[1], tk), (got[2], want[2], tv)):
        assert g is t
        assert_rel(g, w, 1e-2)
