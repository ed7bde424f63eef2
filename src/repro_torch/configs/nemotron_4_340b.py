"""Nemotron-4-340B — dense GQA with squared-ReLU MLP [arXiv:2402.16819].

96L, d_model 18432, 96 heads (GQA kv=8), d_ff 73728, vocab 256000.
Squared-ReLU, ungated MLP.  The 340B scale drives the production choices:
a factored second-moment optimizer (Adafactor), 16-way gradient
accumulation and an int8 decode KV cache.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    head_dim=192,
    activation="relu2",
    gated_mlp=False,
    rope_theta=1e4,
    grad_accum_train4k=16,
    accum_dtype="bfloat16",  # 16 microbatches of similar magnitude: bf16
    # accumulation noise (~0.4%) << SGD noise
    optimizer="adafactor",
    remat="group:8",
    cache_dtype="int8",  # int8 values + per-token-per-head float32 scales:
    # half the bytes of a bf16 cache (attention.quantize_kv)
)
