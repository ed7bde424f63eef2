"""Architecture configuration registry of the LM substrate (the
counterpart of ``repro.configs``).

``get_config(arch_id)`` returns the exact published configuration of each
architecture (one module each, with its source); ``cfg.reduced()`` returns
the family-preserving small config the CPU tests run.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.layers import DTypePolicy
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import MambaConfig, RWKVConfig

__all__ = [
    "ArchConfig",
    "get_config",
    "list_archs",
    "MoEConfig",
    "RWKVConfig",
    "MambaConfig",
]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0  # 0 => attention-free
    n_kv_heads: int = 0
    head_dim: int | None = None
    activation: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    rwkv: RWKVConfig | None = None
    mamba: MambaConfig | None = None
    attn_every: int = 1  # hybrid: attn layer every k-th (jamba: 8)
    enc_layers: int = 0  # encoder-decoder only
    enc_seq: int = 1500  # whisper encoder frames after conv stub
    frontend: str = "none"  # none | audio_stub | vision_stub
    img_tokens: int = 0  # VLM stub patch-embedding count
    sub_quadratic: bool = False  # can run the 500k-context decode cell
    decode_supported: bool = True
    # -- training/runtime knobs (production defaults per arch) -------------
    grad_accum_train4k: int = 1
    accum_dtype: str = "float32"  # grad-accumulation buffer dtype
    optimizer: str = "adamw"  # adamw | adafactor | adamw8bit
    remat: str = "full"  # full | dots | none
    cache_dtype: str = "bfloat16"  # decode KV cache: bfloat16 | int8
    dtype_policy: DTypePolicy = dataclasses.field(default_factory=DTypePolicy)

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def param_count(self) -> float:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)

        def attn_params():
            return (
                d * self.n_heads * hd
                + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d
            )

        def mlp_params(gated=None):
            g = self.gated_mlp if gated is None else gated
            return d * ff * (3 if g else 2)

        if self.family in ("dense", "vlm"):
            return emb + L * (attn_params() + mlp_params())
        if self.family == "moe":
            e = self.moe.num_experts
            return emb + L * (attn_params() + e * mlp_params() + d * e)
        if self.family == "ssm":
            tm = (
                5 * d * d
                + d * 5 * self.rwkv.lora_mix * 2
                + d * self.rwkv.lora_decay * 2
            )
            cm = 2 * d * ff + d * d
            return emb + L * (tm + cm)
        if self.family == "hybrid":
            din = self.mamba.expand * d
            mamba_p = (
                d * 2 * din
                + self.mamba.d_conv * din
                + din * (self.mamba.dt_rank + 2 * self.mamba.d_state)
                + self.mamba.dt_rank * din
                + din * self.mamba.d_state
                + din * d
            )
            n_attn = self.n_layers // self.attn_every
            n_mamba = self.n_layers - n_attn
            n_moe = self.n_layers // self.moe.every_k_layers
            n_dense = self.n_layers - n_moe
            e = self.moe.num_experts
            return (
                emb
                + n_attn * attn_params()
                + n_mamba * mamba_p
                + n_moe * (e * mlp_params() + d * e)
                + n_dense * mlp_params()
            )
        if self.family == "encdec":
            enc = self.enc_layers * (attn_params() + mlp_params())
            dec = L * (2 * attn_params() + mlp_params())
            pos = 32768 * d  # learned decoder positions (_MAX_DEC_POS)
            return emb + pos + enc + dec
        raise ValueError(self.family)

    def active_param_count(self) -> float:
        """Activated parameters per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d, ff = self.d_model, self.d_ff
        mlp = d * ff * (3 if self.gated_mlp else 2)
        e, k = self.moe.num_experts, self.moe.top_k
        if self.family == "moe":
            inactive = self.n_layers * (e - k) * mlp
        else:  # hybrid
            n_moe = self.n_layers // self.moe.every_k_layers
            inactive = n_moe * (e - k) * mlp
        return full - inactive

    def reduced(self) -> "ArchConfig":
        """Family-preserving small config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=max(2, self.attn_every) if self.family == "hybrid" else 2,
            d_model=64,
            d_ff=128,
            vocab=256,
            head_dim=16,
        )
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = 2
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(2, self.moe.top_k)
            )
        if self.rwkv:
            kw["rwkv"] = RWKVConfig(head_dim=16, lora_mix=8, lora_decay=8)
        if self.mamba:
            kw["mamba"] = MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=8)
        if self.enc_layers:
            kw["enc_layers"] = 2
            kw["enc_seq"] = 16
        if self.img_tokens:
            kw["img_tokens"] = 8
        kw["grad_accum_train4k"] = 1
        kw["dtype_policy"] = DTypePolicy("float32", "float32", "float32")
        return dataclasses.replace(self, **kw)


_ARCHS = (
    "yi_9b",
    "smollm_135m",
    "granite_3_8b",
    "nemotron_4_340b",
    "phi35_moe",
    "dbrx_132b",
    "whisper_base",
    "rwkv6_7b",
    "llava_next_mistral_7b",
    "jamba_v01_52b",
)

_ALIASES = {
    "yi-9b": "yi_9b",
    "smollm-135m": "smollm_135m",
    "granite-3-8b": "granite_3_8b",
    "nemotron-4-340b": "nemotron_4_340b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "dbrx-132b": "dbrx_132b",
    "whisper-base": "whisper_base",
    "rwkv6-7b": "rwkv6_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "jamba-v0.1-52b": "jamba_v01_52b",
}


def list_archs():
    return list(_ALIASES)


def get_config(arch: str) -> ArchConfig:
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "")
    if mod_name not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
