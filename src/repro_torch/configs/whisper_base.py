"""Whisper-base — encoder-decoder audio transformer [arXiv:2212.04356].

6 encoder + 6 decoder layers, d_model 512, 8 heads (MHA), d_ff 2048,
vocab 51865.  The conv frontend is a STUB per the assignment: input_specs()
provides precomputed frame embeddings (B, enc_seq, d_model); the encoder
consumes them directly.  GELU MLP, LayerNorm-family norms, sinusoidal
(encoder) positions.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,  # decoder layers
    enc_layers=6,
    enc_seq=1500,  # 30 s of audio after the (stubbed) conv downsampling
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    head_dim=64,
    activation="gelu",
    gated_mlp=False,
    frontend="audio_stub",
    grad_accum_train4k=1,
    optimizer="adamw",
    remat="dots",
)
