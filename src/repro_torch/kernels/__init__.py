# Hand-written CUDA kernels for Hopper (sources in ../csrc), each with an
# ops.py router (CUDA tensor -> kernel or raise; CPU tensor -> plain version)
# and a ref.py plain PyTorch version of the same function:
#   flash_attention/ -- blockwise online-softmax attention (GQA, ragged kv_len)
#   pool_norm/       -- fused masked-pool + L2-normalise embedder epilogue
#   quant_matmul/    -- int8 projections: weight-only GEMM, per-row int8
#                       activations and the int8 x int8 GEMM (W8A8)
#   rmsnorm/         -- fused RMSNorm (the LM's norms)
#   flash_decode/    -- one-token attention against a ring-buffer KV cache
#   ssm_scan/        -- the Mamba-1 selective scan (the LM's prefill)
# build.py compiles the sources with nvcc on first use and loads them.


def _wrappers() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.pool_norm import pool_norm
    from repro_torch.kernels.quant_matmul import (quant_matmul, quantize_rows,
                                                  w8a8_matmul)
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssm_scan import ssm_scan

    return {"flash_attention": flash_attention, "pool_norm": pool_norm,
            "quant_matmul": quant_matmul, "quantize_rows": quantize_rows,
            "w8a8_matmul": w8a8_matmul, "rmsnorm": rmsnorm,
            "flash_decode": flash_decode, "ssm_scan": ssm_scan}


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last ``reset_launch_counts``."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
