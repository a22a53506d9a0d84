"""Roofline terms of a step counted on fake tensors (twin of
``repro.roofline.analysis``).

Three terms per (arch × shape × mesh), in seconds:

    compute    = FLOPs / (chips × peak_FLOP/s)
    memory     = bytes / (chips × HBM_bw)
    collective = collective_bytes / (chips × link_bw)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
collectives from the compiled HLO text.  Here :func:`count_costs` runs the
step once under a ``TorchDispatchMode`` inside ``FakeTensorMode``: every
aten op is seen with its operands' shapes and types, nothing is computed
and nothing is allocated.  It counts

* ``flops``: ``torch.utils.flop_counter``'s formula for each op that has
  one (matrix products, convolutions, attention); elementwise ops count 0;
* ``bytes``: operand plus result bytes of every op that is not a view or
  an allocation -- unfused traffic, the counterpart of XLA-CPU's
  pessimistic "bytes accessed" (``t_memory_hlo``);
* ``transcendentals``: elements through exp / log / tanh / sigmoid /
  rsqrt / erf / sin / cos (and the ops built on them);
* ``coll_bytes``, ``coll_<kind>`` and ``_counts``: result bytes and counts
  of the dispatched ``_c10d_functional`` collectives, by kind (0 on one
  card, where none is dispatched);
* ``peak_bytes``: the peak of live storages, the arguments included,
  counted once per storage however many views share it.

The layers are a Python loop, so every layer is dispatched and counted:
``extrapolate`` over the 0-layer and 1-period variants gives the full
count back, which is the check that the counter sees every layer.

``extrapolate``, ``roofline_terms``, ``model_flops``, ``hbm_floor_bytes``
and ``derive_terms`` are the reference's, line for line: a dry-run record
written by either package gives the same terms in either.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.roofline.hw import ChipSpec

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_aten = torch.ops.aten

# ops that return a tensor without reading or writing memory
_NO_TRAFFIC = frozenset({
    _aten._unsafe_view, _aten.lift_fresh, _aten.empty, _aten.empty_like,
    _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
})

# ops whose every output element goes through a transcendental function
_TRANSCENDENTAL = frozenset({
    _aten.exp, _aten.exp_, _aten.exp2, _aten.expm1, _aten.log, _aten.log_,
    _aten.log2, _aten.log10, _aten.log1p, _aten.tanh, _aten.tanh_,
    _aten.sigmoid, _aten.sigmoid_, _aten.rsqrt, _aten.rsqrt_, _aten.erf,
    _aten.sin, _aten.cos, _aten._softmax, _aten._log_softmax, _aten.silu,
    _aten.silu_, _aten.silu_backward, _aten.gelu, _aten.softplus,
})

# ``_c10d_functional`` op name prefix -> the reference's collective kind
_COLLECTIVE_OPS = (
    ("all_gather", "all-gather"),
    ("all_reduce", "all-reduce"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"),
    ("permute", "collective-permute"),
)


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func) -> str:
    if func.namespace != "_c10d_functional":
        return ""
    name = func.__name__
    for prefix, kind in _COLLECTIVE_OPS:
        if name.startswith(prefix):
            return kind
    return ""


class CostCounter(TorchDispatchMode):
    """Counts what :func:`count_costs` reports; see the module docstring.
    Live storages are held by weak reference: a storage leaves the live
    sum when its last tensor dies."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.coll = {k: 0 for k in COLLECTIVE_KINDS}
        self.coll_counts = {k: 0 for k in COLLECTIVE_KINDS}
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}  # id(storage) -> nbytes, while alive

    def track(self, tree) -> int:
        """Add the storages of ``tree``'s tensors to the live sum (each
        once); the bytes newly added."""
        added = 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = n
            weakref.finalize(st, self._free, key)
            added += n
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        results = _tensors(out)
        if not results:  # a metadata query (``prim.device``, sizes)
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](*args, **kwargs, out_val=out))
        kind = _collective_kind(func)
        if kind:
            self.coll[kind] += sum(map(_nbytes, results))
            self.coll_counts[kind] += 1
        if not func.is_view and packet not in _NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs)) + results))
        if packet in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in results)
        self.track(results)
        return out

    def costs(self) -> Dict[str, Any]:
        """The reference's ``_costs_of`` keys, plus ``peak_bytes``."""
        cs: Dict[str, Any] = {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "transcendentals": float(self.transcendentals),
            "coll_bytes": float(sum(self.coll.values())),
        }
        for k, v in self.coll.items():
            cs[f"coll_{k}"] = float(v)
        cs["peak_bytes"] = float(self.peak)
        cs["_counts"] = dict(self.coll_counts)  # not extrapolated
        return cs


def fake_mode():
    """A fake-tensor mode for :func:`count_costs`: tensors carry shape,
    type and device, never data.  Host constants a step builds (numpy
    position tables) are taken in as fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def count_costs(fn: Callable, *args, mode=None) -> Tuple[Dict[str, Any], Any]:
    """``(costs, out)`` of ``fn(*args)`` run once under ``mode`` (a
    :func:`fake_mode`; the one ``args``' fake tensors were made in, by
    default) with a :class:`CostCounter`.  The arguments' storages are
    live from the start, so ``peak_bytes`` includes them."""
    if mode is None:
        from torch._guards import detect_fake_mode

        mode = detect_fake_mode(_tensors(args)) or fake_mode()
    counter = CostCounter()
    counter.track(args)
    with mode, counter:
        out = fn(*args)
    return counter.costs(), out


@dataclass
class CellCost:
    """Extrapolated per-device totals for one dry-run cell."""

    flops: float
    bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, float]
    coll_counts: Dict[str, int]


def extrapolate(
    c0: Dict[str, float],
    c1: Dict[str, float],
    cfull: Dict[str, float],
    *,
    periods_total: int,
) -> Dict[str, float]:
    """total = C0 + periods_total · (C1 − C0), with a floor at Cfull."""
    out = {}
    keys = set(c0) | set(c1) | set(cfull)
    for k in keys:
        a, b, f = c0.get(k, 0.0), c1.get(k, 0.0), cfull.get(k, 0.0)
        per_period = max(b - a, 0.0)
        out[k] = max(a + periods_total * per_period, f)
    return out


def roofline_terms(
    flops: float, byts: float, coll: float, *, chips: int, chip: ChipSpec,
    per_device: bool = True,
) -> Dict[str, float]:
    """Terms in seconds.  ``per_device=True``: inputs are per-device already
    (the partitioned module), so the chips factor is dropped."""
    div = 1 if per_device else chips
    t_compute = flops / (div * chip.peak_flops_bf16)
    t_memory = byts / (div * chip.hbm_bw)
    t_coll = coll / (div * chip.ici_bw)
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    bound = max(t_compute, t_memory, t_coll)
    return {
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_collective": t_coll,
        "t_bound": bound,
        "dominant": dominant,
    }


def model_flops(cfg, cell, *, original_cfg=None) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (fwd), N = active params.

    Attention score/value FLOPs are added explicitly (they are not in N·D):
    12·L·hd·H·S per token causal-halved for train/prefill; 4·L·H·hd·S_cache
    per decoded token (2 matmuls × 2 flops, GQA on the query side).
    """
    c = original_cfg or cfg
    n_active = c.active_param_count()
    tokens = cell.tokens_per_step
    if cell.kind == "train":
        base = 6.0 * n_active * tokens
    else:
        base = 2.0 * n_active * tokens
    attn = 0.0
    if c.uses_attention:
        H, hd, L = c.num_heads, c.resolved_head_dim, c.num_layers
        if cell.kind in ("train", "prefill"):
            per_tok = 2 * 2 * H * hd * (cell.seq_len / 2)  # causal half
            if c.attention_pattern == "local_global":
                period_ = c.local_global_ratio + 1
                frac_g = 1.0 / period_
                w = min(c.sliding_window, cell.seq_len)
                per_tok = 2 * 2 * H * hd * (
                    frac_g * cell.seq_len / 2 + (1 - frac_g) * w
                )
            attn = L * per_tok * tokens
            if cell.kind == "train":
                attn *= 3  # fwd + 2x bwd
        else:
            per_tok = 2 * 2 * H * hd * cell.seq_len
            if c.attention_pattern == "local_global":
                period_ = c.local_global_ratio + 1
                frac_g = 1.0 / period_
                w = min(c.sliding_window, cell.seq_len)
                per_tok = 2 * 2 * H * hd * (frac_g * cell.seq_len + (1 - frac_g) * w)
            attn = L * per_tok * tokens
    return base + attn


# ---------------------------------------------------------------------------
# Post-hoc term derivation from a dry-run record.
#
# Counted bytes are unfused traffic (every op's operands and results), far
# above what a fused program moves.  The *memory term* therefore uses an
# analytic HBM-traffic model — the bytes that MUST move:
#   decode   : all arguments once (params + KV cache) + cache append
#   prefill  : params + 2 residual passes/layer + KV-cache write
#   train    : params+opt once + residual stream passes/layer
#              (4 = fwd in/out + bwd in/out; +2 with full remat recompute)
# The counted bytes stay in every record ("t_memory_hlo") as the
# pessimistic bound.
# ---------------------------------------------------------------------------


def hbm_floor_bytes(record: dict, cfg, cell, *, dp: int, mp: int) -> float:
    args = float(record["memory"]["argument_bytes"])
    opts = record.get("opts", {})
    accum = max(int(opts.get("grad_accum", 1)), 1)
    remat = opts.get("remat", "full")
    if cell.kind == "decode":
        touched = args
        b_chip = (
            cell.global_batch / dp if cell.global_batch % max(dp, 1) == 0 else cell.global_batch
        )
        if opts.get("window_slice") and cfg.sliding_window and cfg.uses_attention:
            # local layers read only the window, not the whole cache
            period = (cfg.local_global_ratio + 1) if cfg.attention_pattern == "local_global" else 1
            n_global = (
                cfg.num_layers // period if cfg.attention_pattern == "local_global"
                else (0 if cfg.attention_pattern == "local" else cfg.num_layers)
            )
            n_local = cfg.num_layers - n_global
            kv_tok = 2 * max(cfg.num_kv_heads, 1) * cfg.resolved_head_dim * 2  # bytes
            full_cache = cfg.num_layers * b_chip * cell.seq_len * kv_tok / mp
            kept = (
                n_global * b_chip * cell.seq_len * kv_tok / mp
                + n_local * b_chip * min(cfg.sliding_window, cell.seq_len) * kv_tok / mp
            )
            touched = args - full_cache + kept
        return touched + 4 * b_chip * cfg.d_model * 2
    tokens_chip = cell.tokens_per_step / max(dp, 1)
    if cell.kind == "prefill":
        passes = 2
        kv_write = (
            cfg.num_layers * tokens_chip * 2 * max(cfg.num_kv_heads, 1)
            * cfg.resolved_head_dim * 2 / mp
        )
        return args + passes * 2 * tokens_chip * cfg.d_model * cfg.num_layers + kv_write
    passes = {"none": 4, "dots": 5, "full": 6}.get(remat, 6)
    act = passes * 2 * tokens_chip * cfg.d_model * max(cfg.num_layers, 1)
    logits = 2 * tokens_chip * (cfg.vocab_size / mp) * 4  # fwd+bwd, f32
    return args + act + logits


def derive_terms(record: dict, cfg, cell, chip) -> dict:
    """Roofline terms for one dry-run record, memory from the HBM floor."""
    mesh = record["mesh"]
    dims = [int(x) for x in mesh.split("x")]
    mp = dims[-1]
    dp = 1
    for d in dims[:-1]:
        dp *= d
    totals = record["cost_totals"]
    t_compute = totals["flops"] / chip.peak_flops_bf16
    t_mem_hlo = totals["bytes"] / chip.hbm_bw
    floor = hbm_floor_bytes(record, cfg, cell, dp=dp, mp=mp)
    t_memory = floor / chip.hbm_bw
    t_coll = totals["coll_bytes"] / chip.ici_bw
    t_bound = max(t_compute, t_memory, t_coll)
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    mf_chip = record["model_flops_total"] / record["chips"]
    ideal = mf_chip / chip.peak_flops_bf16
    # memory-side ideal: for decode the floor IS the ideal; roofline
    # fraction = ideal-time / bound where ideal includes mandatory bytes
    ideal_mem = floor / chip.hbm_bw if cell.kind == "decode" else 0.0
    frac = max(ideal, ideal_mem) / t_bound if t_bound else 0.0
    return {
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_memory_hlo": t_mem_hlo,
        "t_collective": t_coll,
        "t_bound": t_bound,
        "dominant": dominant,
        "useful_flops_ratio": (mf_chip / totals["flops"]) if totals["flops"] else 0.0,
        "roofline_fraction": frac,
    }
