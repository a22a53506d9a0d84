"""Config dataclasses shared by every architecture.

A ``ModelConfig`` fully determines a model: family dispatch, layer geometry,
attention flavour, MoE/SSM/frontend extras.  A ``ShapeCell`` is one
(input-shape × step-kind) evaluation point from the assignment grid.  The
product (arch × cell) is what the dry-run, the roofline table and the
scheduler's workload pool all iterate over.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | vlm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention flavour ---------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attention_pattern: str = "global"  # "global" | "local_global"
    local_global_ratio: int = 0  # N local layers per 1 global (gemma3: 5)
    sliding_window: int = 0  # window size for local layers
    attn_logit_softcap: float = 0.0

    # --- MoE -------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE

    # --- SSM (Mamba2 / SSD) ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (hymba) ----------------------------------------------------
    parallel_ssm: bool = False  # attention and SSM heads run in parallel

    # --- encoder-decoder (whisper) -----------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    cross_attention: bool = False
    max_source_positions: int = 1500  # whisper cross-cache length

    # --- modality frontend (stubbed per assignment) -------------------------
    frontend: str = "none"  # none | patch_stub | audio_stub
    num_frontend_tokens: int = 0  # e.g. 576 CLIP patches for phi-3-vision

    # --- TP-divisibility padding (set by distributed.sharding.shardable) ----
    d_inner_override: int = 0  # padded SSM inner width (nh padded to mesh)
    vocab_size_real: int = 0  # original vocab before padding (0 = unpadded)

    # --- numerics / impl -----------------------------------------------------
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # q/kv chunk sizes for the chunked (flash-style) attention path.  These
    # are python-unrolled in the dry-run path so XLA cost analysis counts
    # every block (see DESIGN.md §4).
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 2048

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.d_inner_override or (self.ssm_expand * self.d_model)

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def uses_ssm(self) -> bool:
        return self.family == "ssm" or self.parallel_ssm

    @property
    def uses_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def full_attention_only(self) -> bool:
        """True when every token attends to the full (quadratic) context.

        Used by the shape grid: ``long_500k`` is skipped for these archs.
        """
        if self.family in ("ssm", "hybrid"):
            return False
        if self.attention_pattern in ("local_global", "local"):
            return False
        return True

    # ------------------------------------------------------------------
    def layer_is_global(self, layer_idx: int) -> bool:
        """gemma3-style interleaving: ratio local layers then one global."""
        if self.attention_pattern == "local":
            return False
        if self.attention_pattern != "local_global":
            return True
        period = self.local_global_ratio + 1
        return (layer_idx % period) == self.local_global_ratio

    # ------------------------------------------------------------------
    # Parameter counting (used for MODEL_FLOPS = 6·N·D and memory napkins)
    # ------------------------------------------------------------------
    def _per_layer_params(self) -> dict:
        d, hd = self.d_model, self.resolved_head_dim
        out: dict = {}
        if self.uses_attention:
            out["attn_qkvo"] = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qk_norm:
                out["qk_norm"] = 2 * hd
        if self.family == "ssm" or self.parallel_ssm:
            di = self.d_inner
            # in_proj: x->(z, x, B, C, dt heads); conv; out_proj; per-head A/D
            nh = self.ssm_heads
            proj_in = d * (2 * di + 2 * self.ssm_state * 1 + nh)
            conv = self.ssm_conv * (di + 2 * self.ssm_state)
            out["ssm"] = proj_in + conv + di * d + 2 * nh + di
        if self.uses_moe:
            e_ff = self.moe_d_ff or self.d_ff
            out["router"] = d * self.num_experts
            out["experts"] = self.num_experts * 3 * d * e_ff
            if self.num_shared_experts:
                out["shared"] = self.num_shared_experts * 3 * d * e_ff + d
            if self.dense_residual:
                out["dense_ffn"] = 3 * d * self.d_ff
        elif self.d_ff:
            out["ffn"] = 3 * d * self.d_ff  # SwiGLU gate/up/down
        out["norms"] = 2 * d
        return out

    def param_count(self) -> int:
        per_layer = sum(self._per_layer_params().values())
        n = self.num_layers * per_layer
        if self.is_encoder_decoder:
            # encoder layers: self-attn + ffn; decoder adds cross-attn.
            d = self.d_model
            enc_layer = (
                d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                + 3 * d * self.d_ff + 2 * d
            )
            cross = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d + d
            n += self.num_encoder_layers * enc_layer + self.num_layers * cross
        n += self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model  # lm head
        n += self.d_model  # final norm
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-in experts)."""
        if not self.uses_moe:
            return self.param_count()
        per_layer = dict(self._per_layer_params())
        e_ff = self.moe_d_ff or self.d_ff
        per_layer["experts"] = self.num_experts_per_tok * 3 * self.d_model * e_ff
        n = self.num_layers * sum(per_layer.values())
        n += self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        n += self.d_model
        return int(n)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shape grid
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.global_batch * self.seq_len


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)

SHAPES = {c.name: c for c in SHAPE_CELLS}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """(runs?, reason).  Mirrors the assignment's skip rules (DESIGN.md §5)."""
    if cell.name == "long_500k" and cfg.full_attention_only:
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    if cell.name == "long_500k" and cfg.is_encoder_decoder:
        return False, "enc-dec full attention: no sub-quadratic path"
    return True, ""


# ---------------------------------------------------------------------------
# Reduced (smoke) configs — same family wiring, tiny dims.
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config for CPU smoke tests while preserving its structure."""
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(heads, max(1, cfg.num_kv_heads * heads // max(cfg.num_heads, 1))))
    if heads % kv:
        kv = 1
    layers = 2
    if cfg.attention_pattern == "local_global":
        layers = cfg.local_global_ratio + 1  # one full local:global period
    kw = dict(
        num_layers=layers,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        attn_q_chunk=16,
        attn_kv_chunk=16,
        ssm_chunk=16,
        max_source_positions=24,
    )
    if cfg.uses_moe:
        kw.update(
            num_experts=4,
            num_experts_per_tok=min(2, cfg.num_experts_per_tok),
            num_shared_experts=min(1, cfg.num_shared_experts),
            moe_d_ff=32 if cfg.moe_d_ff else 0,
        )
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_head_dim=16, ssm_expand=2)
    if cfg.is_encoder_decoder:
        kw.update(num_encoder_layers=2)
    if cfg.frontend != "none":
        kw.update(num_frontend_tokens=4)
    return cfg.replace(name=cfg.name + "-smoke", **kw)
