"""RWKV-6 (Finch) 7B — attention-free, data-dependent decay
[arXiv:2404.05892; hf].

32L, d_model 4096 (64 heads x head_dim 64), channel-mix d_ff 14336,
vocab 65536.  O(1)-state decode => runs the 500k-context cell.
"""

from repro_torch.configs import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab=65536,
    rwkv=RWKVConfig(head_dim=64, lora_mix=32, lora_decay=64),
    sub_quadratic=True,
    grad_accum_train4k=4,
    optimizer="adamw",
    remat="full",
)
