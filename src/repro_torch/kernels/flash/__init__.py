"""Attention: ``flash_attention`` over the hand-written CUDA kernels
(``csrc/flash.cu``, K4: bfloat16 on the tensor cores, float32 on the FMA
units) and their plain torch version."""
from repro_torch.kernels.flash.flash import flash_cuda, flash_plain, flash_plan
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.kernels.flash.ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_cuda", "flash_plain",
           "flash_plan"]
