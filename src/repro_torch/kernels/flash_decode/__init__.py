from repro_torch.kernels.flash_decode.ops import (decode_attention_ref,
                                                  flash_decode,
                                                  flash_decode_sharded)
from repro_torch.kernels.flash_decode.ref import (combine_shards,
                                                  sharded_decode_ref)

__all__ = ["flash_decode", "flash_decode_sharded", "decode_attention_ref",
           "combine_shards", "sharded_decode_ref"]
