"""Yi-9B — llama-architecture dense GQA model [arXiv:2403.04652; hf].

48L, d_model 4096, 32 heads (GQA kv=4), d_ff 11008, vocab 64000.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    head_dim=128,
    activation="silu",
    gated_mlp=True,
    rope_theta=5e6,
    grad_accum_train4k=4,
    optimizer="adamw",
    remat="full",
)
