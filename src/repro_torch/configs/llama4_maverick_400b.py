"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, vocab=202048, MoE 128 experts top-1 + shared expert; iRoPE-style
3:1 chunked:global attention (chunk window 8192).
[hf:meta-llama/Llama-4-Scout-17B-16E family; unverified]"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = ArchSpec(
    arch_id="llama4-maverick-400b-a17b",
    family="lm",
    model=LMConfig(
        name="llama4-maverick-400b-a17b",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        # assigned d_ff=8192 is the per-expert dim; interleaved dense
        # layers use 16384 (published Maverick: interleave_moe_layer_step=2)
        # -> 401B total / 17.2B active, matching the model name.
        d_ff=16384,
        vocab=202_048,
        rope_theta=500_000.0,
        moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192,
                      n_shared_experts=1, n_groups=32),
        moe_interleave=2,
        local_global=(3, 1),
        window=8192,
        tie_embeddings=False,
    ),
    # chunked-attention layers are sub-quadratic; long_500k runs.
    shapes=lm_shapes(long_skip=None, train_accum=8),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)


def smoke() -> ArchSpec:
    return ArchSpec(
        arch_id="llama4-maverick-smoke",
        family="lm",
        model=LMConfig(
            name="llama4-maverick-smoke",
            n_layers=4,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            d_ff=128,
            vocab=512,
            moe=MoEConfig(n_experts=4, top_k=1, d_ff=128,
                          n_shared_experts=1),
            local_global=(3, 1),
            window=8,
            tie_embeddings=False,
            remat=False,
        ),
        shapes=lm_shapes(long_skip=None),
    )
