"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone: 32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 32000.
The vision tower + anyres tiling is a STUB per the assignment: input_specs()
provides precomputed patch embeddings (B, img_tokens, d_model) which are
prepended to the token embeddings (576 base-resolution patches).
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    activation="silu",
    gated_mlp=True,
    rope_theta=1e4,
    frontend="vision_stub",
    img_tokens=576,
    grad_accum_train4k=4,
    optimizer="adamw",
    remat="full",
)
