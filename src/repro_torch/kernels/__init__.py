# Hand-written CUDA kernels for Hopper (sources in ../csrc), each with an
# ops.py router (CUDA tensor -> kernel or raise; CPU tensor -> plain version)
# and a ref.py plain PyTorch version of the same function:
#   flash_attention/ -- blockwise online-softmax attention (GQA, ragged kv_len)
#   pool_norm/       -- fused masked-pool + L2-normalise embedder epilogue
# build.py compiles the sources with nvcc on first use and loads them.


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last ``reset_launch_counts``."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pool_norm import pool_norm

    return {"flash_attention": flash_attention.launches,
            "pool_norm": pool_norm.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pool_norm import pool_norm

    flash_attention.launches = 0
    pool_norm.launches = 0
