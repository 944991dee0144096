from repro_torch.kernels.quant_matmul.ops import (quant_matmul,
                                                  quant_matmul_ref,
                                                  quant_matmul_w8a8,
                                                  quantize_activations,
                                                  quantize_rows, w8a8_matmul,
                                                  w8a8_matmul_ref)

__all__ = ["quant_matmul", "quant_matmul_ref", "quant_matmul_w8a8",
           "quantize_activations", "quantize_rows", "w8a8_matmul",
           "w8a8_matmul_ref"]
