"""Attention: ``flash_attention`` over the hand-written CUDA kernels
(``csrc/flash.cu``, K4: bfloat16 on the tensor cores, float32 there as
three TF32 passes at head dims that are multiples of 8 up to 128 and on
the FMA units otherwise; ``csrc/flash_bwd.cu``, its backward, bfloat16
on the tensor cores where TMA can read the rows, float32 in three TF32
passes up to head dim 64, the rest on the FMA units) and their
plain torch versions."""
from repro_torch.kernels.flash.flash import (
    FlashAttentionFn,
    flash_backward_cuda,
    flash_bwd_plan,
    flash_cuda,
    flash_plain,
    flash_plain_backward,
    flash_plan,
)
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.kernels.flash.ref import attention_ref

__all__ = ["FlashAttentionFn", "attention_ref", "flash_attention",
           "flash_backward_cuda", "flash_bwd_plan", "flash_cuda",
           "flash_plain", "flash_plain_backward", "flash_plan"]
