"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B family; hf]"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = ArchSpec(
    arch_id="qwen3-moe-235b-a22b",
    family="lm",
    model=LMConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        vocab=151_936,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536,
                      n_groups=32),
        tie_embeddings=False,
    ),
    shapes=lm_shapes(
        train_accum=8,
        long_skip="pure full-attention stack; long_500k reserved for "
        "sub-quadratic archs (DESIGN.md §Arch-applicability)"
    ),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)


def smoke() -> ArchSpec:
    return ArchSpec(
        arch_id="qwen3-moe-235b-a22b-smoke",
        family="lm",
        model=LMConfig(
            name="qwen3-moe-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            d_ff=64,
            vocab=512,
            moe=MoEConfig(n_experts=8, top_k=2, d_ff=64),
            tie_embeddings=False,
            remat=False,
        ),
        shapes=lm_shapes(long_skip="smoke"),
    )
