"""Sharding rules: params / optimizer / batches / caches per architecture.

Twin of ``repro.distributed.sharding``: pure functions of the config, the
mesh's shape and the leaves' shapes, whose specs equal the reference's
``PartitionSpec`` entry for entry.  On one card a spec does not split
anything (``distributed/meshes.py``): the specs name the layout the
reference's SPMD program would take, and placing a leaf under one puts
it on the mesh's card.

Baseline layout (2-D ``(data, model)`` mesh, optionally with a leading
``pod`` axis that joins the data axes):

* Megatron-style TP on the ``model`` axis: attention heads, FFN hidden,
  MoE experts (EP) or expert-hidden (when E doesn't divide), SSM heads;
  vocab-sharded embedding/head.
* DP over ``(pod, data)`` for activations; ZeRO-style optimizer-state
  sharding adds the data axes to the first evenly-divisible unsharded dim.
* K/V that don't divide the model axis stay replicated (GQA kv<TP), which
  is the standard Megatron fallback.

``shardable(cfg, model_par)`` pads head/expert/vocab counts to the mesh
where the published numbers don't divide (phi4 24H->32H, arctic 56H->64H,
gemma3 8H->16H, hymba 25H/5KV/50ssmH->32/8/64, qwen2-moe 60E->64E,
whisper 8H->16H, mamba2 vocab->%16).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.meshes import AbstractMesh as Mesh
from repro_torch.distributed.meshes import NamedSharding, P
from repro_torch.tree import tree_map, tree_map_with_path


# ---------------------------------------------------------------------------
# Mesh introspection
# ---------------------------------------------------------------------------


def mesh_dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mesh_dp_size(mesh: Mesh) -> int:
    n = 1
    for a in mesh_dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def mesh_model_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


# ---------------------------------------------------------------------------
# TP-divisibility padding
# ---------------------------------------------------------------------------


def _pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def shardable(cfg: ModelConfig, model_par: int) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Pad the config so TP on ``model_par`` partitions divides evenly."""
    changes: Dict[str, Any] = {}
    kw: Dict[str, Any] = {}

    if cfg.uses_attention and cfg.num_heads % model_par:
        new_h = _pad_to(cfg.num_heads, model_par)
        # keep GQA grouping integral
        kv = cfg.num_kv_heads
        while new_h % kv:
            kv += 1
        if kv != cfg.num_kv_heads:
            kw["num_kv_heads"] = kv
            changes["num_kv_heads"] = (cfg.num_kv_heads, kv)
        kw["num_heads"] = new_h
        changes["num_heads"] = (cfg.num_heads, new_h)

    if cfg.uses_moe and cfg.num_experts % model_par and cfg.num_experts > model_par:
        new_e = _pad_to(cfg.num_experts, model_par)
        kw["num_experts"] = new_e
        changes["num_experts"] = (cfg.num_experts, new_e)

    if cfg.uses_ssm:
        nh = cfg.ssm_heads
        if nh % model_par:
            new_nh = _pad_to(nh, model_par)
            kw["d_inner_override"] = new_nh * cfg.ssm_head_dim
            changes["ssm_heads"] = (nh, new_nh)

    if cfg.vocab_size % model_par:
        new_v = _pad_to(cfg.vocab_size, model_par)
        kw["vocab_size"] = new_v
        kw["vocab_size_real"] = cfg.vocab_size
        changes["vocab_size"] = (cfg.vocab_size, new_v)

    return (cfg.replace(**kw) if kw else cfg), changes


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def param_spec_for(cfg: ModelConfig, mesh: Mesh, path: str, shape: Tuple[int, ...]) -> P:
    """PartitionSpec for one parameter leaf (shape includes any leading L)."""
    m = mesh_model_size(mesh)
    stacked = ("blocks" in path) or ("enc_blocks" in path)
    core = shape[1:] if stacked else shape
    name = path.split("/")[-1]

    attn_tp = cfg.uses_attention and cfg.num_heads % m == 0
    kv_tp = cfg.uses_attention and cfg.num_kv_heads % m == 0
    ff = cfg.d_ff
    moe_ep = cfg.uses_moe and cfg.num_experts % m == 0
    moe_ff = cfg.moe_d_ff or cfg.d_ff
    ssm_tp = cfg.uses_ssm and cfg.ssm_heads % m == 0 and cfg.d_inner % m == 0

    def spec(*core_spec):
        return P(*((None,) + core_spec if stacked else core_spec))

    # --- embeddings / head ------------------------------------------------
    if name == "embed":
        return P("model", None) if cfg.vocab_size % m == 0 else P(None, None)
    if name == "lm_head":
        return P(None, "model") if cfg.vocab_size % m == 0 else P(None, None)
    if name in ("final_norm", "enc_norm"):
        return P(None)

    # --- attention ----------------------------------------------------------
    if name in ("wq",) and ("attn" in path or "cross" in path):
        return spec(None, "model") if attn_tp else spec(None, None)
    if name in ("wk", "wv") and ("attn" in path or "cross" in path):
        return spec(None, "model") if kv_tp else spec(None, None)
    if name == "wo":
        return spec("model", None) if attn_tp else spec(None, None)

    # --- MoE -----------------------------------------------------------------
    if "experts" in path and name in ("gate", "up"):
        if moe_ep:
            return spec("model", None, None)
        return spec(None, None, "model") if moe_ff % m == 0 else spec(None, None, None)
    if "experts" in path and name == "down":
        if moe_ep:
            return spec("model", None, None)
        return spec(None, "model", None) if moe_ff % m == 0 else spec(None, None, None)
    if name == "router":
        return spec(None, None)
    if "shared" in path and name in ("gate", "up"):
        shared_ff = cfg.num_shared_experts * moe_ff
        return spec(None, "model") if shared_ff % m == 0 else spec(None, None)
    if "shared" in path and name == "down":
        shared_ff = cfg.num_shared_experts * moe_ff
        return spec("model", None) if shared_ff % m == 0 else spec(None, None)
    if name == "shared_gate":
        return spec(None, None)

    # --- dense FFN (mlp / arctic dense residual) ------------------------------
    if ("mlp" in path or "dense_ffn" in path) and name in ("gate", "up"):
        ffd = cfg.d_ff
        return spec(None, "model") if ffd % m == 0 else spec(None, None)
    if ("mlp" in path or "dense_ffn" in path) and name == "down":
        ffd = cfg.d_ff
        return spec("model", None) if ffd % m == 0 else spec(None, None)

    # --- SSM ------------------------------------------------------------------
    if name in ("wz", "wx"):
        return spec(None, "model") if ssm_tp else spec(None, None)
    if name == "conv_x":
        return spec(None, "model") if ssm_tp else spec(None, None)
    if name in ("conv_bx", "norm") and "ssm" in path:
        return spec("model") if ssm_tp else spec(None)
    if name == "out_proj":
        return spec("model", None) if ssm_tp else spec(None, None)
    if name in ("A_log", "D", "dt_bias"):
        return spec("model") if ssm_tp else spec(None)
    if name == "wdt":
        return spec(None, "model") if ssm_tp else spec(None, None)
    if name in ("wbc", "conv_bc", "conv_bbc"):
        return spec(*([None] * len(core)))

    # --- norms / scalars / anything else: replicated ---------------------------
    return spec(*([None] * len(core)))


def param_specs(cfg: ModelConfig, mesh: Mesh, params_shape) -> Any:
    """Pytree of PartitionSpec matching a params template (eval_shape ok)."""

    def one(path, leaf):
        return param_spec_for(cfg, mesh, path, tuple(leaf.shape))

    return tree_map_with_path(one, params_shape)


def named(mesh: Mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# ZeRO-style optimizer-state specs
# ---------------------------------------------------------------------------


def zero_extend(spec: P, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Add the data axes to the first evenly-divisible unsharded dim."""
    dp = mesh_dp_axes(mesh)
    dp_size = mesh_dp_size(mesh)
    if not dp or dp_size == 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (s, dim) in enumerate(zip(parts, shape)):
        if s is None and dim % dp_size == 0 and dim >= dp_size:
            parts[i] = dp if len(dp) > 1 else dp[0]
            return P(*parts)
    return spec


def opt_state_specs(cfg: ModelConfig, mesh: Mesh, opt_shape, *, zero: bool = True):
    """Specs for AdamW state {m, v, count}.

    fp32/bf16 moments mirror the param layout (+ZeRO extension over the
    data axes); int8 moments ({"q": (nb, BLOCK), "scale": (nb, 1)}) shard
    the block dim over data.
    """
    dp = mesh_dp_axes(mesh)
    dp_size = mesh_dp_size(mesh)
    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)

    def one(path, leaf):
        if path == "count":
            return P()
        name = path.split("/", 1)[1]  # drop the leading "m"/"v" key
        if name.split("/")[-1] in ("q", "scale"):  # int8 block layout
            # shape = param.shape[:-1] + (nb, BLOCK|1): inherit the param's
            # leading-dim sharding, block dims unsharded
            pname = "/".join(name.split("/")[:-1])
            lead = tuple(leaf.shape[:-2])
            base = param_spec_for(cfg, mesh, pname, lead + (leaf.shape[-2] * 256,))
            parts = (list(base) + [None] * len(leaf.shape))[: max(len(lead), 0)]
            spec = P(*(tuple(parts) + (None, None)))
            if zero:
                return zero_extend(spec, tuple(leaf.shape), mesh)
            return spec
        base = param_spec_for(cfg, mesh, name, tuple(leaf.shape))
        if zero:
            return zero_extend(base, tuple(leaf.shape), mesh)
        return base

    return tree_map_with_path(one, opt_shape)


# ---------------------------------------------------------------------------
# Batch / cache / activation specs
# ---------------------------------------------------------------------------


def _dp_spec_or_none(mesh: Mesh, batch: int):
    dp = mesh_dp_axes(mesh)
    n = mesh_dp_size(mesh)
    if n > 1 and batch % n == 0:
        return dp if len(dp) > 1 else dp[0]
    return None


def batch_specs(cfg: ModelConfig, mesh: Mesh, batch_shapes: Dict[str, Tuple[int, ...]]):
    out = {}
    for k, shp in batch_shapes.items():
        b = _dp_spec_or_none(mesh, shp[0])
        out[k] = P(*((b,) + (None,) * (len(shp) - 1)))
    return out


def cache_specs(cfg: ModelConfig, mesh: Mesh, cache_shapes: Dict[str, Tuple[int, ...]]):
    """Decode-cache layout: batch over data; KV sequence over model."""
    m = mesh_model_size(mesh)
    out = {}
    for k, shp in cache_shapes.items():
        b = _dp_spec_or_none(mesh, shp[1])
        if k in ("k", "v") and len(shp) == 6 and shp[3] % m == 0:
            # striped layout (L,B,nblk,w,KVH,hd): shard the window offset —
            # any window read stays local and balanced (§Perf G2)
            out[k] = P(None, b, None, "model", None, None)
        elif k in ("k", "v") and shp[2] % m == 0:
            out[k] = P(None, b, "model", None, None)
        elif k == "h" and cfg.uses_ssm and cfg.ssm_heads % m == 0:
            out[k] = P(None, b, "model", None, None)
        elif k == "conv" and cfg.uses_ssm and cfg.d_inner % m == 0:
            # channels = [x (di, sharded) | bc (2N, replicated)] — keep whole
            out[k] = P(None, b, None, None)
        else:
            out[k] = P(*((None, b) + (None,) * (len(shp) - 2)))
    return out


def activation_rules(cfg: ModelConfig, mesh: Mesh, batch: int) -> Dict[str, NamedSharding]:
    """Residual stream: batch over data, replicated over model (Megatron).

    Deliberately NO constraint on "attn_out": the head-sharded attention
    output must flow *sharded* into the row-parallel wo matmul, whose
    partial sums all-reduce once.  Constraining it replicated forced an
    all-gather + 16x-redundant wo compute (§Perf iteration Q1 — found via
    the dry-run collective breakdown: 460 GB/chip of spurious all-gathers
    on qwen3 train_4k).
    """
    b = _dp_spec_or_none(mesh, batch)
    res = NamedSharding(mesh, P(b, None, None))
    return {"embed": res, "residual": res}
