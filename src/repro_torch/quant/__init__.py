"""Quantization: symmetric int8/int4 quantization, packed int4 storage,
the quantized weight leaves the serving path dispatches through, and
quantized linear layers.

Exports the reference's `repro.quant` names but one: `quantize` stays
the name of the submodule (`repro_torch.quant.quantize.quantize` is the
function), which the port's code and tests import as a module."""
from repro_torch.quant.quantize import (dequantize, pack_int4,
                                        quantize_int4, unpack_int4)
from repro_torch.quant.linear import (QuantLinearParams, quant_linear,
                                      quantize_linear_params)

__all__ = ["QuantLinearParams", "dequantize", "pack_int4", "quant_linear",
           "quantize_int4", "quantize_linear_params", "unpack_int4"]
