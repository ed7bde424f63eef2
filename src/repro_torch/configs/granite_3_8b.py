"""Granite-3 8B — IBM dense GQA model [hf:ibm-granite/granite-3.0 family].

40L, d_model 4096, 32 heads (GQA kv=8), d_ff 12800, vocab 49155.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    head_dim=128,
    activation="silu",
    gated_mlp=True,
    rope_theta=1e4,
    grad_accum_train4k=4,
    optimizer="adamw",
    remat="full",
)
