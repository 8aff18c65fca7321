"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3. [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = ArchSpec(
    arch_id="llama3.2-1b",
    family="lm",
    model=LMConfig(
        name="llama3.2-1b",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab=128_256,
        rope_theta=500_000.0,
        tie_embeddings=True,
    ),
    shapes=lm_shapes(
        train_accum=2,
        long_skip="pure full-attention stack; long_500k reserved for "
        "sub-quadratic archs (DESIGN.md §Arch-applicability)"
    ),
    source="hf:meta-llama/Llama-3.2-1B; unverified",
)


def smoke() -> ArchSpec:
    return ArchSpec(
        arch_id="llama3.2-1b-smoke",
        family="lm",
        model=LMConfig(
            name="llama3.2-1b-smoke",
            n_layers=2,
            d_model=64,
            n_heads=8,
            n_kv_heads=2,
            head_dim=8,
            d_ff=256,
            vocab=512,
            remat=False,
        ),
        shapes=lm_shapes(long_skip="smoke"),
    )
