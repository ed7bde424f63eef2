"""SmolLM-135M — small llama-architecture dense model
[hf:HuggingFaceTB/SmolLM-135M].

30L, d_model 576, 9 heads (GQA kv=3), d_ff 1536, vocab 49152, tied embeddings.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49152,
    head_dim=64,
    activation="silu",
    gated_mlp=True,
    tie_embeddings=True,
    rope_theta=1e4,
    grad_accum_train4k=1,
    optimizer="adamw",
    remat="full",
)
