"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model 4096, 32 heads (GQA kv=8), expert d_ff 6400, vocab 32064,
MoE 16 experts top-2 in every layer.
"""

from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    head_dim=128,
    activation="silu",
    gated_mlp=True,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=16, top_k=2, capacity_factor=1.25),
    grad_accum_train4k=4,
    optimizer="adamw",
    remat="full",
)
