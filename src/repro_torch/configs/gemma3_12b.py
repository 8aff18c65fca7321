"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global interleave, sliding window 1024.
[hf:google/gemma-3-12b-pt family; unverified]"""
from repro_torch.configs.base import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = ArchSpec(
    arch_id="gemma3-12b",
    family="lm",
    model=LMConfig(
        name="gemma3-12b",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab=262_144,
        rope_theta=1_000_000.0,
        local_global=(5, 1),
        window=1024,
        tie_embeddings=True,
    ),
    # local layers are sub-quadratic (sliding window); long_500k runs.
    shapes=lm_shapes(long_skip=None, train_accum=8),
    source="hf:google/gemma-3-1b-pt; unverified",
)


def smoke() -> ArchSpec:
    return ArchSpec(
        arch_id="gemma3-12b-smoke",
        family="lm",
        model=LMConfig(
            name="gemma3-12b-smoke",
            n_layers=6,
            d_model=64,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            d_ff=128,
            vocab=512,
            local_global=(5, 1),
            window=8,
            remat=False,
        ),
        shapes=lm_shapes(long_skip=None),
    )
