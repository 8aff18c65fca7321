"""Attention: ``flash_attention`` over the hand-written CUDA kernel
(``csrc/flash.cu``, K4) and its plain torch version."""
from repro_torch.kernels.flash.flash import flash_cuda, flash_plain
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.kernels.flash.ref import attention_ref

__all__ = ["attention_ref", "flash_attention", "flash_cuda", "flash_plain"]
