from repro_torch.kernels.flash_attention.ops import (FlashAttentionFn,
                                                     attention_bwd_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)

__all__ = ["flash_attention", "flash_attention_bwd", "FlashAttentionFn", "attention_ref", "attention_bwd_ref"]
