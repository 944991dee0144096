from repro_torch.kernels.rmsnorm.ops import (RMSNormFn, rmsnorm, rmsnorm_bwd,
                                             rmsnorm_bwd_ref, rmsnorm_ref)

__all__ = ["rmsnorm", "rmsnorm_bwd", "RMSNormFn", "rmsnorm_ref",
           "rmsnorm_bwd_ref"]
