from repro_torch.kernels.pool_norm.ops import pool_norm, pool_norm_ref

__all__ = ["pool_norm", "pool_norm_ref"]
