"""Unified model zoo: one ``Model`` class driving every arch.

Twin of ``repro.models.model``.  Families: dense / moe / ssm / hybrid /
vlm / audio (enc-dec); MoE layers take ``models/moe.py``'s dense
dispatch, or its expert-parallel ``moe_apply_ep`` under a
``distributed.ctx.mesh_context`` (``Runtime.moe_impl``).  One stacked
parameter tree with a leading ``L`` axis, as in the reference, so the
reference's parameters carry over leaf for leaf
(``core/carry.params_from_numpy``).  Where the reference scans over
periods of layers, this class loops over the periods in Python (the
stacked leaves unbound once a pass, so a backward pass stacks each
leaf's gradient once); a layer's window flag is
``cfg.layer_is_global(li % period)`` either way.

API (plain functions of explicit parameter dicts):
    init(rng, device=)               -> params
    forward(params, batch)           -> logits            (teacher forcing)
    loss(params, batch)              -> (loss, metrics)
    prefill(params, batch)           -> (last_logits, cache)
    init_cache(batch, cache_len)     -> zeroed cache dict
    decode_step(params, cache, token, pos) -> (logits, cache)

Caches are returned anew, never updated in place (the reference's
functional semantics).  ``constrain`` marks the reference's sharding
points ("embed", "residual", "attn_out"; no-ops on one card).  Where
grad is on, ``Runtime.remat`` recomputes each period of layers in the
backward pass as the reference's ``jax.checkpoint`` around its scanned
period does (and each encoder layer): ``"full"`` keeps only the period's
input (``torch.utils.checkpoint``, non-reentrant), ``"dots"`` keeps the
matmul outputs too (``checkpoint_dots``' counterpart, a selective
checkpoint policy); the trailing layers that do not fill a period run
without it, as the reference's unrolled tail.  Serving runs without
grad, where remat does nothing.

Modality frontends are stubs, as in the reference: batches carry
precomputed patch/frame embeddings (``patch_embeds`` / ``src_embeds``).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.ctx import constrain, current_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.attention import attention
from repro_torch.models.common import (
    apply_rope,
    dense_init,
    dtype_of,
    embed_init,
    head_rms_norm,
    rms_norm,
    sinusoidal_positions,
    softmax_cross_entropy,
    swiglu_apply,
    swiglu_init,
)


@dataclass(frozen=True)
class Runtime:
    """Implementation knobs orthogonal to the architecture."""

    attn_impl: str = "auto"  # auto | dense | blocked | pallas
    remat: str = "full"  # none | full | dots
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    # decode on sliding-window layers slices the last ``window`` cache
    # entries instead of masking the full sequence
    decode_window_slice: bool = False
    # "ep" routes MoE through the expert-parallel path (requires a
    # mesh_context); "auto" uses it whenever a mesh is active and E
    # divides the model axis; "dense" keeps the scatter dispatch
    moe_impl: str = "dense"


_DOTS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
})


def _save_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots``: keep matmul outputs, recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` recomputed in the backward pass (``jax.checkpoint``); the
    model draws no random numbers, so no RNG state is kept."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if mode == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    elif mode != "full":
        raise ValueError(f"unknown remat mode {mode!r}")
    return functools.partial(checkpoint, fn, **kw)


# ``_traverse`` unbinds each stacked ``(L, ...)`` leaf once a pass, so the
# backward pass stacks each leaf's gradient once; False indexes ``x[li]``
# out of the stacked leaf in each layer instead (each layer's backward then
# adds its slice into a zero tensor the size of the whole leaf).  Only
# ``tools/train_traverse_ablation.py`` sets it, to time the two.
_UNBIND = True


def _tmap(fn, *trees):
    """``fn`` over the leaves of nested dicts (None leaves stay None)."""
    if isinstance(trees[0], dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack(trees):
    """Stack the leaves of per-layer dicts along a new leading axis.  Each
    leaf is taken out of its dict as it is stacked, so the per-layer
    copies are freed leaf by leaf (at full width the layers' weights
    would otherwise be held twice)."""
    out = {}
    for k in list(trees[0]):
        if isinstance(trees[0][k], dict):
            out[k] = _stack([t[k] for t in trees])
        else:
            out[k] = torch.stack([t.pop(k) for t in trees])
    return out


def _sinusoid_at(pos: int, dim: int, device) -> torch.Tensor:
    """Sinusoidal embedding for a scalar position without a full table."""
    half = dim // 2
    log_timescale = math.log(10_000) / (half - 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=device))
    scaled = float(pos) * inv  # a host scalar: no copy to the card
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


class Model:
    def __init__(self, cfg: ModelConfig, rt: Runtime = Runtime()):
        self.cfg = cfg
        self.rt = rt
        self.dtype = dtype_of(cfg.dtype)
        self.period = (
            cfg.local_global_ratio + 1
            if cfg.attention_pattern == "local_global"
            else 1
        )
        self._enc_out = None  # set during enc-dec passes

    # ==================================================================
    # Init
    # ==================================================================
    def _attn_init(self, gen) -> dict:
        cfg, dt = self.cfg, self.dtype
        d = cfg.d_model
        return {
            "ln": torch.zeros((d,), dtype=dt, device=gen.device),
            "wq": dense_init(gen, d, cfg.q_dim, dt),
            "wk": dense_init(gen, d, cfg.kv_dim, dt),
            "wv": dense_init(gen, d, cfg.kv_dim, dt),
            "wo": dense_init(gen, cfg.q_dim, d, dt),
        }

    def _init_block(self, gen) -> dict:
        cfg, dt = self.cfg, self.dtype
        d = cfg.d_model
        zeros = lambda n: torch.zeros((n,), dtype=dt, device=gen.device)  # noqa: E731
        block: Dict[str, Any] = {}
        if cfg.uses_attention:
            attn = self._attn_init(gen)
            if cfg.qk_norm:
                attn["q_norm"] = zeros(cfg.resolved_head_dim)
                attn["k_norm"] = zeros(cfg.resolved_head_dim)
            block["attn"] = attn
        if cfg.uses_ssm:
            block["ssm"] = ssd_mod.ssd_init(gen, cfg, dt)
            if not cfg.uses_attention:
                block["ssm_ln"] = zeros(d)
        if cfg.cross_attention:
            block["cross"] = self._attn_init(gen)
        if cfg.uses_moe:
            block["moe_ln"] = zeros(d)
            block["moe"] = moe_mod.moe_init(gen, cfg, dt)
        elif cfg.d_ff:
            block["mlp_ln"] = zeros(d)
            block["mlp"] = swiglu_init(gen, d, cfg.d_ff, dt)
        return block

    def _init_enc_block(self, gen) -> dict:
        cfg, dt = self.cfg, self.dtype
        return {
            "attn": self._attn_init(gen),
            "mlp_ln": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
            "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, dt),
        }

    def init(self, rng: Union[int, torch.Generator] = 0, *, device=None) -> dict:
        """Random parameters drawn from ``rng`` straight on the device.
        ``rng`` is a seed (the parameters go to ``device``, ``"cuda"``
        when not given) or a ``torch.Generator`` (they go to its device;
        a ``device`` that names another raises).  The numbers are not the
        reference's (another generator); carry the reference's
        parameters with ``core.carry.params_from_numpy``."""
        cfg, dt = self.cfg, self.dtype
        gen = rng
        if isinstance(gen, torch.Generator):
            dev = resolve_device(gen.device)
            want = dev if device is None else resolve_device(device)
            if want.type != dev.type or (
                    want.index is not None and dev.index is not None
                    and want.index != dev.index):
                raise ValueError(
                    f"device={want} but the generator lies on {dev}")
        else:
            dev = resolve_device("cuda" if device is None else device)
            gen = torch.Generator(device=dev).manual_seed(int(rng))
        embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
        if cfg.num_layers:
            blocks = _stack([self._init_block(gen) for _ in range(cfg.num_layers)])
        else:  # no layers (the dry-run's 0-layer variant): leaves of leading extent 0
            blocks = _tmap(lambda x: x.new_empty((0, *x.shape)), self._init_block(gen))
        params: Dict[str, Any] = {
            "embed": embed,
            "blocks": blocks,
            "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
        if cfg.is_encoder_decoder:
            params["enc_blocks"] = _stack(
                [self._init_enc_block(gen) for _ in range(cfg.num_encoder_layers)])
            params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=dt, device=dev)
        return params

    # ==================================================================
    # Sublayers
    # ==================================================================
    def _qkv(self, attn_bp: dict, h, positions):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        B, S, _ = h.shape
        x = rms_norm(h, attn_bp["ln"], cfg.norm_eps)
        q = (x @ attn_bp["wq"]).reshape(B, S, cfg.num_heads, hd)
        k = (x @ attn_bp["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
        v = (x @ attn_bp["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
        if cfg.qk_norm:
            q = head_rms_norm(q, attn_bp["q_norm"], cfg.norm_eps)
            k = head_rms_norm(k, attn_bp["k_norm"], cfg.norm_eps)
        if cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _self_attention(self, q, k, v, *, is_global: bool):
        cfg = self.cfg
        return attention(
            q, k, v,
            causal=True,
            window=0 if is_global else cfg.sliding_window,
            softcap=cfg.attn_logit_softcap,
            impl=self.rt.attn_impl,
            q_chunk=cfg.attn_q_chunk,
            kv_chunk=cfg.attn_kv_chunk,
        )

    def _attn_sublayer(self, attn_bp, h, *, is_global: bool, positions):
        q, k, v = self._qkv(attn_bp, h, positions)
        o = self._self_attention(q, k, v, is_global=is_global)
        o = constrain(o.reshape(*h.shape[:2], self.cfg.q_dim), "attn_out")
        return o @ attn_bp["wo"]

    def _mlp_sublayer(self, bp, h):
        cfg = self.cfg
        if cfg.uses_moe:
            x = rms_norm(h, bp["moe_ln"], cfg.norm_eps)
            if self.rt.moe_impl in ("ep", "auto"):
                mesh = current_mesh()
                if mesh is not None and cfg.num_experts % mesh.shape.get("model", 1) == 0:
                    return moe_mod.moe_apply_ep(bp["moe"], x, cfg, mesh,
                                                capacity_factor=self.rt.capacity_factor)
                if self.rt.moe_impl == "ep":
                    raise RuntimeError("moe_impl='ep' requires an active mesh_context")
            return moe_mod.moe_apply(bp["moe"], x, cfg,
                                     capacity_factor=self.rt.capacity_factor)
        x = rms_norm(h, bp["mlp_ln"], cfg.norm_eps)
        return swiglu_apply(bp["mlp"], x)

    def _ssm_prenorm(self, bp, h):
        ln = bp["ssm_ln"] if "ssm_ln" in bp else bp["attn"]["ln"]
        return rms_norm(h, ln, self.cfg.norm_eps)

    def _cross_sublayer(self, cp, h, enc_out):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        B, S, _ = h.shape
        Se = enc_out.shape[1]
        x = rms_norm(h, cp["ln"], cfg.norm_eps)
        q = (x @ cp["wq"]).reshape(B, S, cfg.num_heads, hd)
        k = (enc_out @ cp["wk"]).reshape(B, Se, cfg.num_kv_heads, hd)
        v = (enc_out @ cp["wv"]).reshape(B, Se, cfg.num_kv_heads, hd)
        o = attention(q, k, v, causal=False, impl="dense")
        return o.reshape(B, S, cfg.q_dim) @ cp["wo"]

    # ==================================================================
    # One layer: train-forward / prefill / decode
    # ==================================================================
    def _block_fwd(self, bp, h, *, is_global: bool, positions, enc_out=None):
        cfg = self.cfg
        if cfg.family == "ssm":
            return h + ssd_mod.ssd_apply(bp["ssm"], self._ssm_prenorm(bp, h), cfg)
        if cfg.parallel_ssm:
            a = self._attn_sublayer(bp["attn"], h, is_global=is_global, positions=positions)
            s = ssd_mod.ssd_apply(bp["ssm"], self._ssm_prenorm(bp, h), cfg)
            h = h + a + s
        else:
            h = h + self._attn_sublayer(bp["attn"], h, is_global=is_global,
                                        positions=positions)
        if "cross" in bp:
            h = h + self._cross_sublayer(bp["cross"], h, enc_out)
        h = h + self._mlp_sublayer(bp, h)
        return constrain(h, "residual")

    def _block_prefill(self, bp, h, *, is_global: bool, positions):
        """Like _block_fwd but also returns this layer's cache entries."""
        cfg = self.cfg
        B, S, _ = h.shape
        lc: Dict[str, Any] = {}
        parts = []
        if cfg.uses_attention:
            q, k, v = self._qkv(bp["attn"], h, positions)
            o = self._self_attention(q, k, v, is_global=is_global)
            parts.append(o.reshape(B, S, cfg.q_dim) @ bp["attn"]["wo"])
            lc["k"], lc["v"] = k, v
        if cfg.uses_ssm:
            x = self._ssm_prenorm(bp, h)
            out, state, conv_tail = self._ssd_with_state(bp["ssm"], x)
            parts.append(out)
            lc["h"] = state
            lc["conv"] = conv_tail
        h = h + sum(parts)
        if "cross" in bp:
            hd = cfg.resolved_head_dim
            Se = self._enc_out.shape[1]
            lc["cross_k"] = (self._enc_out @ bp["cross"]["wk"]).reshape(
                B, Se, cfg.num_kv_heads, hd)
            lc["cross_v"] = (self._enc_out @ bp["cross"]["wv"]).reshape(
                B, Se, cfg.num_kv_heads, hd)
            h = h + self._cross_sublayer(bp["cross"], h, self._enc_out)
        if cfg.uses_moe or cfg.d_ff:
            h = h + self._mlp_sublayer(bp, h)
        return h, lc

    def _ssd_with_state(self, sp, x):
        """SSD over a full sequence, returning output + decode-ready state."""
        return ssd_mod.ssd_forward(sp, x, self.cfg)

    def _striped_attention(self, q, k6, v6, pos: int, *, window: int, is_global: bool):
        """Attention over a striped (B, nblk, w, KVH, hd) cache.

        Local layers read only the ≤2 blocks covering [pos-w+1, pos];
        global layers read all blocks.
        """
        cfg = self.cfg
        B, _, H, hd = q.shape
        KVH = k6.shape[-2]
        G = H // KVH
        w = k6.shape[2]
        scale = 1.0 / math.sqrt(hd)
        qg = q.reshape(B, 1, KVH, G, hd)
        if is_global:
            k_att, v_att, blk0 = k6, v6, 0
        else:
            nblk = k6.shape[1]
            blk0 = min(max(pos // w - 1, 0), nblk - 2)
            k_att = k6[:, blk0:blk0 + 2]
            v_att = v6[:, blk0:blk0 + 2]
        s = torch.einsum("bqhgd,bBwhd->bhgqBw", qg.float(), k_att.float()) * scale
        if cfg.attn_logit_softcap > 0:
            s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
        nB, nw = k_att.shape[1], k_att.shape[2]
        dev = q.device
        pos_abs = ((blk0 + torch.arange(nB, device=dev))[:, None] * w
                   + torch.arange(nw, device=dev)[None, :])
        mask = pos_abs <= pos
        if not is_global:
            mask &= pos_abs > pos - window
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m = s.amax(dim=(-2, -1), keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=(-2, -1), keepdim=True)
        p = p / torch.clamp(l, min=1e-37)
        o = torch.einsum("bhgqBw,bBwhd->bqhgd", p.to(v_att.dtype), v_att)
        return o.reshape(B, 1, H, hd)

    def _block_decode(self, bp, lc, h, pos: int, *, is_global: bool):
        """One layer of single-token decode.  h (B, 1, d)."""
        cfg = self.cfg
        nc = dict(lc)
        positions = torch.full((h.shape[0], 1), pos, device=h.device)
        window = 0 if is_global else cfg.sliding_window
        parts = []
        if cfg.uses_attention and lc.get("k") is not None and lc["k"].dim() == 5:
            # striped cache layout (B, nblk, w, KVH, hd)
            q, k_new, v_new = self._qkv(bp["attn"], h, positions)
            w = lc["k"].shape[2]
            blk, off = pos // w, pos % w
            k_cache, v_cache = lc["k"].clone(), lc["v"].clone()
            k_cache[:, blk, off] = k_new[:, 0]
            v_cache[:, blk, off] = v_new[:, 0]
            o = self._striped_attention(q, k_cache, v_cache, pos, window=window,
                                        is_global=is_global)
            parts.append(o.reshape(*h.shape[:2], cfg.q_dim) @ bp["attn"]["wo"])
            nc["k"], nc["v"] = k_cache, v_cache
        elif cfg.uses_attention:
            q, k_new, v_new = self._qkv(bp["attn"], h, positions)
            S_cap = lc["k"].shape[1]
            if not 0 <= pos < S_cap:
                raise IndexError(f"decode position {pos} outside the cache of {S_cap}")
            k_cache, v_cache = lc["k"].clone(), lc["v"].clone()
            k_cache[:, pos:pos + 1] = k_new
            v_cache[:, pos:pos + 1] = v_new
            if self.rt.decode_window_slice and window and window < S_cap:
                # touch only the window, not the whole cache
                start = min(max(pos - window + 1, 0), S_cap - window)
                k_att = k_cache[:, start:start + window]
                v_att = v_cache[:, start:start + window]
                kv_off = start
            else:
                k_att, v_att, kv_off = k_cache, v_cache, 0
            o = attention(
                q, k_att, v_att,
                causal=False,  # masking via kv_valid_len / window
                window=window,
                q_offset=pos,
                kv_offset=kv_off,
                kv_valid_len=pos + 1,
                softcap=cfg.attn_logit_softcap,
                impl="dense",
            )
            parts.append(o.reshape(*h.shape[:2], cfg.q_dim) @ bp["attn"]["wo"])
            nc["k"], nc["v"] = k_cache, v_cache
        if cfg.uses_ssm:
            x = self._ssm_prenorm(bp, h)
            s_out, s_state = ssd_mod.ssd_decode_step(
                bp["ssm"], {"conv": lc["conv"], "h": lc["h"]}, x, cfg)
            parts.append(s_out)
            nc["conv"], nc["h"] = s_state["conv"], s_state["h"]
        h = h + sum(parts)
        if "cross" in bp:
            h = h + self._cross_decode(bp["cross"], h, lc)
        if cfg.uses_moe or cfg.d_ff:
            h = h + self._mlp_sublayer(bp, h)
        return h, nc

    def _cross_decode(self, cp, h, lc):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        B, S, _ = h.shape
        x = rms_norm(h, cp["ln"], cfg.norm_eps)
        q = (x @ cp["wq"]).reshape(B, S, cfg.num_heads, hd)
        o = attention(q, lc["cross_k"], lc["cross_v"], causal=False, impl="dense")
        return o.reshape(B, S, cfg.q_dim) @ cp["wo"]

    # ==================================================================
    # Layer-stack traversal: a Python loop over periods of layers, each
    # period recomputed in the backward pass under ``Runtime.remat``, then
    # the trailing layers.  ``layer_fn(bp, carry, j, x_li) -> (carry,
    # ys|None)`` with j the layer's index within its period.
    # ==================================================================
    def _traverse(self, blocks, carry, layer_fn, extra_xs: Optional[dict] = None):
        L, period = self.cfg.num_layers, self.period
        if L == 0:
            return carry, extra_xs
        layers = _tmap(lambda x: x.unbind(0), blocks) if _UNBIND else blocks

        def run(c, lo, hi):
            out = []
            for li in range(lo, hi):
                bp = _tmap(lambda x: x[li], layers)
                x_li = None if extra_xs is None else _tmap(lambda x: x[li], extra_xs)
                c, y = layer_fn(bp, c, li % period, x_li)
                out.append(y)
            return c, out

        n_scan = L // period
        periodic = _remat(run, self.rt.remat)
        ys = []
        for i in range(n_scan):
            carry, out = periodic(carry, i * period, (i + 1) * period)
            ys += out
        carry, out = run(carry, n_scan * period, L)
        ys += out
        return carry, (None if ys[0] is None else _stack(ys))

    # ==================================================================
    # Embedding / head / encoder
    # ==================================================================
    def _embed(self, params, batch):
        cfg = self.cfg
        tokens = batch["tokens"]
        h = params["embed"][tokens.long()]
        if cfg.frontend == "patch_stub" and "patch_embeds" in batch:
            n = cfg.num_frontend_tokens
            pe = batch["patch_embeds"].to(h.dtype)
            h = torch.cat([pe, h[:, n:]], dim=1)
        if cfg.rope_theta <= 0:
            S = h.shape[1]
            pos_tab = torch.from_numpy(sinusoidal_positions(S, cfg.d_model)).to(h.device)
            h = h + pos_tab[None].to(h.dtype)
        return constrain(h, "embed")

    def _head(self, params, h):
        cfg = self.cfg
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return h @ w

    def _encode(self, params, src_embeds):
        cfg = self.cfg
        B, S, d = src_embeds.shape
        pos_tab = torch.from_numpy(sinusoidal_positions(S, d)).to(src_embeds.device)
        h = src_embeds.to(self.dtype) + pos_tab[None].to(self.dtype)
        hd = cfg.resolved_head_dim

        def enc_block(h, bp):
            x = rms_norm(h, bp["attn"]["ln"], cfg.norm_eps)
            q = (x @ bp["attn"]["wq"]).reshape(B, S, cfg.num_heads, hd)
            k = (x @ bp["attn"]["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
            v = (x @ bp["attn"]["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
            o = attention(q, k, v, causal=False, impl=self.rt.attn_impl,
                          q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
            h = h + o.reshape(B, S, cfg.q_dim) @ bp["attn"]["wo"]
            return h + swiglu_apply(bp["mlp"], rms_norm(h, bp["mlp_ln"], cfg.norm_eps))

        block = _remat(enc_block, self.rt.remat)
        layers = _tmap(lambda x: x.unbind(0), params["enc_blocks"])
        for li in range(cfg.num_encoder_layers):
            h = block(h, _tmap(lambda x: x[li], layers))
        return rms_norm(h, params["enc_norm"], cfg.norm_eps)

    # ==================================================================
    # Public API
    # ==================================================================
    def forward(self, params, batch):
        cfg = self.cfg
        self._enc_out = (
            self._encode(params, batch["src_embeds"]) if cfg.is_encoder_decoder else None
        )
        h = self._embed(params, batch)
        S = batch["tokens"].shape[1]
        positions = torch.arange(S, device=h.device)[None, :]
        enc_out = self._enc_out  # recomputed periods read it after this returns

        def layer_fn(bp, c, j, _):
            return self._block_fwd(bp, c, is_global=cfg.layer_is_global(j),
                                   positions=positions, enc_out=enc_out), None

        h, _ = self._traverse(params["blocks"], h, layer_fn)
        logits = self._head(params, h)
        self._enc_out = None
        return logits

    def loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        cfg = self.cfg
        logits = self.forward(params, batch)
        tokens = batch["tokens"]
        targets = batch.get("targets")
        if targets is None:
            targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
        mask[:, -1] = 0.0
        if cfg.frontend == "patch_stub":
            mask[:, :cfg.num_frontend_tokens] = 0.0
        ce = softmax_cross_entropy(logits, targets)
        loss = (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        metrics = {"ce": loss}
        if cfg.uses_moe and cfg.num_layers > 0:
            aux = self._moe_aux(params, batch)
            metrics["moe_aux"] = aux
            loss = loss + self.rt.moe_aux_coef * aux
        return loss, metrics

    def _moe_aux(self, params, batch):
        """The load-balancing loss of the first layer's router on the
        embeddings, as the reference computes it."""
        cfg = self.cfg
        h = self._embed(params, batch)
        bp0 = _tmap(lambda x: x[0], params["blocks"])
        return moe_mod.moe_aux_loss(bp0["moe"], rms_norm(h, bp0["moe_ln"], cfg.norm_eps),
                                    cfg)

    # ------------------------------------------------------------------
    def _striped(self, cache_len: int) -> bool:
        """Cyclic (block, offset) cache layout for windowed archs: the
        attention window spans ≤2 blocks."""
        w = self.cfg.sliding_window
        return (
            self.rt.decode_window_slice
            and self.cfg.uses_attention
            and w > 0
            and cache_len % w == 0
            and cache_len // w >= 2
        )

    def init_cache(self, batch: int, cache_len: int, *, device="cuda") -> dict:
        cfg, dt = self.cfg, self.dtype
        dev = resolve_device(device)
        L = cfg.num_layers

        def zeros(shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        cache: Dict[str, Any] = {}
        if cfg.uses_attention and self._striped(cache_len):
            w = cfg.sliding_window
            kv = (L, batch, cache_len // w, w, cfg.num_kv_heads, cfg.resolved_head_dim)
            cache["k"], cache["v"] = zeros(kv), zeros(kv)
        elif cfg.uses_attention:
            kv = (L, batch, cache_len, cfg.num_kv_heads, cfg.resolved_head_dim)
            cache["k"], cache["v"] = zeros(kv), zeros(kv)
        if cfg.uses_ssm:
            conv_ch = cfg.d_inner + 2 * cfg.ssm_state
            cache["conv"] = zeros((L, batch, cfg.ssm_conv - 1, conv_ch))
            cache["h"] = zeros(
                (L, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32)
        if cfg.is_encoder_decoder:
            xs = (L, batch, cfg.max_source_positions, cfg.num_kv_heads,
                  cfg.resolved_head_dim)
            cache["cross_k"], cache["cross_v"] = zeros(xs), zeros(xs)
        return cache

    def prefill(self, params, batch):
        """Run the full prompt; return (last-position logits, filled cache)."""
        cfg = self.cfg
        self._enc_out = (
            self._encode(params, batch["src_embeds"]) if cfg.is_encoder_decoder else None
        )
        h = self._embed(params, batch)
        S = batch["tokens"].shape[1]
        positions = torch.arange(S, device=h.device)[None, :]

        def layer_fn(bp, c, j, _):
            return self._block_prefill(bp, c, is_global=cfg.layer_is_global(j),
                                       positions=positions)

        h, cache = self._traverse(params["blocks"], h, layer_fn)
        logits = self._head(params, h[:, -1:, :])
        self._enc_out = None
        return logits, cache

    def decode_step(self, params, cache, token, pos: int):
        """token (B, 1) int; pos the write index (an int).  Returns
        (logits (B,1,V), updated cache)."""
        cfg = self.cfg
        pos = int(pos)
        h = params["embed"][token.long()]
        if cfg.rope_theta <= 0:
            h = h + _sinusoid_at(pos, cfg.d_model, h.device)[None, None].to(h.dtype)

        def layer_fn(bp, c, j, lc):
            return self._block_decode(bp, lc, c, pos, is_global=cfg.layer_is_global(j))

        h, new_cache = self._traverse(params["blocks"], h, layer_fn, extra_xs=cache)
        logits = self._head(params, h)
        return logits, new_cache


def build_model(cfg: ModelConfig, rt: Runtime = Runtime()) -> Model:
    return Model(cfg, rt)
