"""The port's kernels against the JAX reference kernels.

On the CPU each router takes the kernel's plain PyTorch version; it is held
against the reference's plain version and against its Pallas kernel run in
interpret mode, on the same numpy inputs.  The kernels themselves are held
against their plain versions on the card in ``test_torch_kernels_card.py``.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.pool_norm.pool_norm import pool_norm_pallas  # noqa: E402
from repro.kernels.pool_norm.ref import \
    pool_norm_ref as jax_pool_norm_ref  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_attention)
from repro_torch.kernels.flash_attention.ref import \
    attention_mask  # noqa: E402
from repro_torch.kernels.pool_norm import (pool_norm,  # noqa: E402
                                           pool_norm_ref)

# fp32: both sides compute in fp32, summation order differs.  bf16: the
# output is rounded to bf16 (2^-8 relative) and the port rounds P to bf16
# before the PV product, which the reference's plain version does not.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (B, H, KV, S, hd, causal, window, kv_len)
ATTN_CASES = [
    (2, 4, 4, 24, 16, False, 0, [24, 0]),              # MHA, padding row
    (3, 4, 2, 40, 32, False, 0, [40, 17, 0]),          # GQA G=2, ragged
    (2, 4, 1, 33, 16, False, 0, [33, 1]),              # GQA G=4, kv_len 1
    (2, 2, 2, 48, 32, True, 0, [48, 20]),              # causal + ragged
    (2, 4, 2, 48, 16, True, 12, [48, 30]),             # sliding window
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread each, so parallel test workers do
    not oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attn_inputs(B, H, KV, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, hd), np.float32),
            rng.standard_normal((B, KV, S, hd), np.float32),
            rng.standard_normal((B, KV, S, hd), np.float32))


def _row_has_key(B, S, causal, window, kv_len):
    """(B, S) bool: query rows with at least one valid key."""
    return attention_mask(B, S, S, causal=causal, window=window,
                          kv_len=torch.tensor(kv_len),
                          device="cpu").any(-1).numpy()


def _as(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax_as(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"B{c[0]}H{c[1]}KV{c[2]}S{c[3]}hd{c[4]}"
                              f"{'c' if c[5] else ''}w{c[6]}"
                              for c in ATTN_CASES])
def test_attention_plain_matches_jax_ref_and_pallas(case, dtype):
    B, H, KV, S, hd, causal, window, kv_len = case
    q, k, v = _attn_inputs(B, H, KV, S, hd)
    got = flash_attention(_as(q, dtype), _as(k, dtype), _as(v, dtype),
                          causal=causal, window=window,
                          kv_len=torch.tensor(kv_len, dtype=torch.int32))
    got = got.float().numpy()
    jargs = (_jax_as(q, dtype), _jax_as(k, dtype), _jax_as(v, dtype))
    jkv = jnp.asarray(kv_len, jnp.int32)
    want_ref = np.asarray(jax_attention_ref(
        *jargs, causal=causal, window=window, kv_len=jkv).astype(jnp.float32))
    want_pallas = np.asarray(flash_attention_pallas(
        *jargs, causal=causal, window=window, block_q=32, block_k=32,
        interpret=True, kv_len=jkv).astype(jnp.float32))
    rows = _row_has_key(B, S, causal, window, kv_len)       # (B, S)
    assert np.isfinite(got).all()
    # a row with no valid key (kv_len = 0) comes out as zeros, the
    # convention of the reference's attention_ref
    assert (got.transpose(0, 2, 1, 3)[~rows] == 0).all()
    sel = np.broadcast_to(rows[:, None, :], got.shape[:3])
    np.testing.assert_allclose(got[sel], want_ref[sel], atol=TOL[dtype])
    np.testing.assert_allclose(got[sel], want_pallas[sel], atol=TOL[dtype])


def test_attention_strided_views_match_contiguous():
    """attn_forward passes (B, S, H, hd) projections as transposed views."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 20, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 20, 2, 16), np.float32))
    kv_len = torch.tensor([20, 7])
    a = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        k.transpose(1, 2), causal=False, kv_len=kv_len)
    b = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(), causal=False,
                        kv_len=kv_len)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


POOL_LENS = [7, 0, 1, 5]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["mean", "cls"])
def test_pool_norm_plain_matches_jax_ref_and_pallas(pool, dtype):
    rng = np.random.default_rng(1)
    h = rng.standard_normal((4, 7, 32), np.float32)
    mask = (np.arange(7)[None] < np.array(POOL_LENS)[:, None]).astype(
        np.float32)
    got = pool_norm(_as(h, dtype), torch.from_numpy(mask), pool).numpy()
    assert got.dtype == np.float32
    jh = _jax_as(h, dtype)
    want_ref = np.asarray(jax_pool_norm_ref(jh, jnp.asarray(mask), pool))
    want_pallas = np.asarray(pool_norm_pallas(jh, jnp.asarray(mask), pool,
                                              block_b=2, interpret=True))
    np.testing.assert_allclose(got, want_ref, atol=1e-6)
    np.testing.assert_allclose(got, want_pallas, atol=1e-6)
    assert (got[1] == 0).all()                 # fully masked row -> zeros
    np.testing.assert_allclose(np.linalg.norm(got[[0, 2, 3]], axis=-1), 1.0,
                               atol=1e-6)


def test_pool_norm_rejects_unknown_mode():
    with pytest.raises(ValueError):
        pool_norm(torch.zeros(1, 2, 4), torch.ones(1, 2), "max")



def _variants_module():
    """benchmarks/torch_kernel_variants.py, imported from its path."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_variants",
        os.path.join(root, "benchmarks", "torch_kernel_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _OtherDevice(torch.Tensor):
    """A tensor that says it lies on an XLA device: no backend behind it,
    and no data (any op on it raises)."""

    @staticmethod
    def __new__(cls, shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device="xla")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a tensor with no backend")


class TestRouting:
    def test_cpu_tensors_take_the_plain_version(self):
        q, k, v = (torch.from_numpy(x) for x in _attn_inputs(2, 4, 2, 9, 16))
        kv_len = torch.tensor([9, 3])
        before = flash_attention.launches
        torch.testing.assert_close(
            flash_attention(q, k, v, causal=False, kv_len=kv_len),
            attention_ref(q, k, v, causal=False, kv_len=kv_len),
            rtol=0, atol=0)
        h, m = torch.randn(2, 9, 8), torch.ones(2, 9)
        pn_before = pool_norm.launches
        torch.testing.assert_close(pool_norm(h, m, "mean"),
                                   pool_norm_ref(h, m, "mean"),
                                   rtol=0, atol=0)
        # the plain version is not a launch of the kernel
        assert flash_attention.launches == before
        assert pool_norm.launches == pn_before

    def test_other_devices_raise_instead_of_falling_back(self):
        # a device with no route (the meta device has one since the dry
        # run: the kernel's empty outputs, tests/test_torch_dryrun.py)
        q = _OtherDevice((1, 2, 4, 16))
        with pytest.raises(ValueError, match="no route"):
            flash_attention(q, q, q)
        with pytest.raises(ValueError, match="no route"):
            pool_norm(_OtherDevice((1, 4, 8)), _OtherDevice((1, 4)))

    def test_build_module_imports_nothing_gpu_only(self):
        code = ("import sys; import repro_torch.kernels.build as b; "
                "import repro_torch.kernels.flash_attention, "
                "repro_torch.kernels.pool_norm; "
                "assert b._lib is None; "
                "assert 'triton' not in sys.modules; "
                "print(sorted(p.name for p in b.sources()))")
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True).stdout
        assert "flash_attention.cu" in out and "pool_norm.cu" in out

    def test_library_name_tracks_the_sources(self):
        path = build.library_path()
        assert path.parent == build.BUILD_DIR
        assert path.parent.parts[-2:] == ("build", "kernels")
        assert path == build.library_path()    # stable for unchanged sources
        assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


    @pytest.mark.parametrize("name", ["w8a8", "rmsnorm", "attention_fp32",
                                      "ssm_scan", "quantize_rows",
                                      "attention_bwd", "rmsnorm_bwd",
                                      "ssm_scan_bwd"])
    def test_kernel_variant_substitutions_apply_to_the_sources(self, name):
        """benchmarks/torch_kernel_variants.py times variants made by
        literal substitutions in this tree's CUDA sources: each must still
        find its text, or the variant would time the tree's kernel."""
        mod = _variants_module()
        for variant, (src, subs, from_parent) in mod.SETS[name].items():
            if from_parent:
                continue
            text = (build.CSRC / src).read_text()
            for old, _ in subs:
                assert old in text, (variant, old)

    def test_variants_written_for_an_older_parent_are_skipped(self):
        """A parent variant whose text the parent at hand lacks gives no
        source (it is skipped, and the set runs on); a variant of this
        tree whose text is missing stops the run."""
        mod = _variants_module()
        src = "ssm_scan.cu"
        tree = (build.CSRC / src).read_text()
        assert mod.variant_source("parent", mod.ROOT, src, [], True) == tree
        missing = [("no such text", "")]
        assert mod.variant_source("v", mod.ROOT, src, missing, True) is None
        with pytest.raises(SystemExit):
            mod.variant_source("v", mod.ROOT, src, missing, False)
        # the scan backward's ablations of its 512-thread design, with this
        # tree as the parent
        _, subs, from_parent = mod.SETS["ssm_scan_bwd"]["ablate_partials"]
        assert from_parent
        assert mod.variant_source("ablate_partials", mod.ROOT, src, subs,
                                  True) is None
