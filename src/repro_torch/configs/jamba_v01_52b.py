"""Jamba-v0.1 (52B total) — Mamba + attention 7:1 interleave with MoE
[arXiv:2403.19887].

32L, d_model 4096; attention layer every 8th layer (32 heads, GQA kv=8);
Mamba (d_state 16, d_conv 4, expand 2) elsewhere; MoE (16 experts top-2)
every 2nd layer, dense SwiGLU (d_ff 14336) otherwise.  Hybrid => runs the
500k-context decode cell (only 4 attention layers hold KV caches).
"""

from repro_torch.configs import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    activation="silu",
    gated_mlp=True,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=16, top_k=2, every_k_layers=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
    attn_every=8,
    sub_quadratic=True,
    grad_accum_train4k=8,
    optimizer="adamw",
    remat="full",
)
