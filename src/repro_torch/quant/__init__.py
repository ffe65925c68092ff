"""Quantization: symmetric int8/int4 quantization, packed int4 storage and
the quantized weight leaves the serving path dispatches through."""
