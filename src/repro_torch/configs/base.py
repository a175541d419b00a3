"""Config system: ModelConfig (architecture), ShapeConfig (workload) and
the arch registry, copied as data from the JAX package. ``input_specs``
(the dry-run's ShapeDtypeStruct builder) is not ported.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional



@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_experts: int = 0
    norm_topk_probs: bool = True
    layer_period: int = 1      # MoE every k-th layer
    aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25  # sparse-dispatch buffer headroom


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 256  # ~ d_model/16


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor_mlstm: float = 2.0
    slstm_period: int = 8  # 1 sLSTM per 8 blocks (xLSTM[7:1])


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    attention: str = "gqa"  # gqa | mla
    sliding_window: Optional[int] = None
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    attn_period: int = 1   # jamba: 1 attention per 8 layers
    first_dense_layers: int = 0  # deepseek: 3 dense layers before MoE
    mlp_gated: bool = True  # SwiGLU (False: plain GELU — musicgen)
    tie_embeddings: bool = False
    mtp_depth: int = 0     # deepseek multi-token prediction heads
    embeds_input: bool = False  # audio/vlm stub: precomputed frame/patch embeds
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ----------------------------------------------------------- pattern
    def layer_kinds(self) -> list[tuple[str, str]]:
        """The repeating (mixer, ffn) pattern of the MAIN stack — one
        period. ``first_dense_layers`` (deepseek) form a separate dense
        prefix stack (see models/model.py)."""
        import math

        period = 1
        if self.xlstm:
            period = self.xlstm.slstm_period
        if self.attn_period > 1:
            period = max(period, self.attn_period)
        if self.moe:
            period = math.lcm(period, self.moe.layer_period)
        kinds = []
        for i in range(period):
            if self.xlstm:
                mixer = "slstm" if (i % self.xlstm.slstm_period) == self.xlstm.slstm_period - 1 else "mlstm"
                kinds.append((mixer, "none"))
                continue
            if self.mamba and self.attn_period > 1:
                mixer = "attn" if (i % self.attn_period) == 0 else "mamba"
            else:
                mixer = "attn"
            if self.moe and (i % self.moe.layer_period) == self.moe.layer_period - 1:
                ffn = "moe"
            else:
                ffn = "mlp"
            kinds.append((mixer, ffn))
        assert (self.n_layers - self.first_dense_layers) % len(kinds) == 0, (
            self.n_layers, self.first_dense_layers, len(kinds))
        return kinds

    @property
    def n_groups(self) -> int:
        return (self.n_layers - self.first_dense_layers) // len(self.layer_kinds())

    # -------------------------------------------------------- param count
    def param_count(self) -> int:
        """Total parameters N (used for MODEL_FLOPS = 6·N·D)."""
        import numpy as np
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        all_layers = [("attn", "mlp")] * self.first_dense_layers + (
            self.layer_kinds() * self.n_groups
        )
        for mixer, ffn in all_layers:
            total += d  # norm1
            if mixer == "attn":
                if self.attention == "mla":
                    m = self.mla
                    qh = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qh
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d
                    total += m.q_lora_rank + m.kv_lora_rank
                else:
                    total += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    total += self.n_heads * hd * d
            elif mixer == "mamba":
                mb = self.mamba
                di = mb.expand * d
                total += d * 2 * di + mb.d_conv * di + di
                total += di * (2 * mb.d_state + mb.dt_rank) + mb.dt_rank * di + di
                total += di * mb.d_state + di + di * d
            elif mixer == "mlstm":
                dp = int(self.xlstm.proj_factor_mlstm * d)
                dh = dp // self.n_heads
                # block-diagonal q/k/v: H·dh² each
                total += d * 2 * dp + 3 * self.n_heads * dh * dh
                total += dp * 2 * self.n_heads + dp + dp * d
            elif mixer == "slstm":
                total += 8 * d * d + 4 * d + d * d
            if ffn == "mlp":
                total += 3 * d * self.d_ff + d
            elif ffn == "moe":
                mo = self.moe
                total += d * mo.num_experts
                total += mo.num_experts * 3 * d * mo.d_ff_expert
                if mo.shared_experts:
                    total += 3 * d * mo.d_ff_expert * mo.shared_experts
                total += d
        total += d  # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if not self.moe:
            return self.param_count()
        mo = self.moe
        inactive_per_moe_layer = (mo.num_experts - mo.top_k) * 3 * self.d_model * mo.d_ff_expert
        n_moe_layers = sum(1 for _, f in self.layer_kinds() if f == "moe") * self.n_groups
        return int(self.param_count() - n_moe_layers * inactive_per_moe_layer)


# ---------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic sequence mixing)
LONG_CONTEXT_OK = {"mixtral-8x7b", "jamba-1.5-large-398b", "xlstm-1.3b"}


def cell_supported(arch_name: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch_name not in LONG_CONTEXT_OK:
        return False, "full quadratic attention at 512k infeasible (DESIGN.md §4)"
    return True, ""


# -------------------------------------------------------------- registry
ARCH_IDS = [
    "mixtral-8x7b",
    "deepseek-v3-671b",
    "jamba-1.5-large-398b",
    "musicgen-large",
    "qwen2-vl-7b",
    "tinyllama-1.1b",
    "phi3-mini-3.8b",
    "olmo-1b",
    "llama3-405b",
    "xlstm-1.3b",
]

_MOD = {
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "musicgen-large": "musicgen_large",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "olmo-1b": "olmo_1b",
    "llama3-405b": "llama3_405b",
    "xlstm-1.3b": "xlstm_1_3b",
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")
    return mod.SMOKE
