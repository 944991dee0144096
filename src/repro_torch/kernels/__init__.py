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
#
# Backward kernels exist for flash_attention, rmsnorm and ssm_scan (their
# routers go through a torch.autograd.Function under autograd).  Every other
# router refuses autograd on the card (``refuse_grad``): it raises rather
# than return an output cut from the graph.  CPU tensors go to the plain
# versions, which autograd differentiates.

SERVING_BWD_ITEM = ("ROADMAP.md Queue 1 item 10, backward kernels of the "
                    "serving kernels")


def refuse_grad(what: str, item: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    ``tensors`` requires grad: ``what`` has no backward kernel on the card
    yet (``item`` names the ROADMAP entry for it)."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: no backward kernel on the card, so it cannot carry a "
            f"gradient ({item}); run it under torch.no_grad() or on CPU "
            f"tensors (the plain version)")


def _wrappers() -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.pool_norm import pool_norm
    from repro_torch.kernels.quant_matmul import (quant_matmul, quantize_rows,
                                                  w8a8_matmul)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd

    return {"flash_attention": flash_attention, "pool_norm": pool_norm,
            "quant_matmul": quant_matmul, "quantize_rows": quantize_rows,
            "w8a8_matmul": w8a8_matmul, "rmsnorm": rmsnorm,
            "flash_decode": flash_decode, "ssm_scan": ssm_scan,
            "flash_attention_bwd": flash_attention_bwd,
            "rmsnorm_bwd": rmsnorm_bwd, "ssm_scan_bwd": ssm_scan_bwd}


def launch_counts() -> dict:
    """Launches of each kernel wrapper since the last ``reset_launch_counts``."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
