"""The canonical packed quantized-tensor format."""

from .qtensor import QuantizedTensor, dequantize_tensor, pack_rows, quantize_tensor, unpack_rows

__all__ = ["QuantizedTensor", "pack_rows", "unpack_rows", "quantize_tensor", "dequantize_tensor"]
