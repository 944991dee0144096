from repro_torch.kernels.flash_decode.ops import (decode_attention_ref,
                                                  flash_decode)

__all__ = ["flash_decode", "decode_attention_ref"]
