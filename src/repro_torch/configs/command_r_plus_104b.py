"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, parallel attn+FFN block.
[hf:CohereForAI/c4ai-command-r-plus family; unverified]"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = ArchSpec(
    arch_id="command-r-plus-104b",
    family="lm",
    model=LMConfig(
        name="command-r-plus-104b",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab=256_000,
        rope_theta=75_000_000.0,
        parallel_block=True,
        tie_embeddings=True,
    ),
    shapes=lm_shapes(
        train_accum=16,
        long_skip="pure full-attention stack; long_500k reserved for "
        "sub-quadratic archs (DESIGN.md §Arch-applicability)"
    ),
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)


def smoke() -> ArchSpec:
    return ArchSpec(
        arch_id="command-r-plus-104b-smoke",
        family="lm",
        model=LMConfig(
            name="command-r-plus-104b-smoke",
            n_layers=2,
            d_model=96,
            n_heads=6,
            n_kv_heads=2,
            head_dim=16,
            d_ff=256,
            vocab=512,
            parallel_block=True,
            remat=False,
        ),
        shapes=lm_shapes(long_skip="smoke"),
    )
