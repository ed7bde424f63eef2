"""DBRX-132B — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].

40L, d_model 6144, 48 heads (GQA kv=8), expert d_ff 10752, vocab 100352.
"""

from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    head_dim=128,
    activation="silu",
    gated_mlp=True,
    rope_theta=5e5,
    moe=MoEConfig(num_experts=16, top_k=4, capacity_factor=1.25),
    grad_accum_train4k=8,
    optimizer="adamw",
    remat="full",
)
