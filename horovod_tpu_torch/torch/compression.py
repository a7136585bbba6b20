"""Gradient compression (port of ``horovod_tpu/torch/compression.py``):
the none / fp16 / bf16 compressors, and the int8 / int4 markers of the
block-scaled quantized wire."""

import torch


class Compressor:
    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Halve allreduce bytes for float tensors: IEEE float16 on the
    wire, like the reference."""

    wire_dtype = torch.float16

    @classmethod
    def compress(cls, tensor):
        if tensor.dtype.is_floating_point:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class BF16Compressor(FP16Compressor):
    wire_dtype = torch.bfloat16


class Int8Compressor(Compressor):
    """Block-scaled int8 wire (``ops/quantize.py``: per 256-element block
    one bf16 absmax scale and 256 int8 codes, ~3.97x fewer wire bytes
    than f32) with error feedback.

    Codes under different scales cannot be summed, so this is a
    *marker*, not a cast: ``DistributedOptimizer`` passes
    ``wire_dtype='int8'`` to the collective, whose engine quantizes the
    fused buffer on the device, and keeps per-parameter residuals
    ``e = g - dequantize(quantize(g))`` that it adds into the next
    step's gradient, so the quantization bias cancels over steps."""

    #: wire format the optimizer forwards to the collective
    wire = "int8"

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class Int4Compressor(Int8Compressor):
    """Block-scaled int4 wire (packed nibbles + bf16 scales, ~7.9x fewer
    wire bytes than f32), the same marker with the same error
    feedback."""

    wire = "int4"


class Compression:
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int4 = Int4Compressor
    #: former name of the IEEE-f16 compressor, now the default fp16
    fp16_ieee = FP16Compressor
