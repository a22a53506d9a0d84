"""AdamW with selectable moment precision: fp32 / bf16 / int8-blockwise.

Twin of ``repro.optim.adamw``.  The int8 path stores both Adam moments as
symmetric int8 blocks of 256 along the last axis with float32 scales
(``{"q": (..., nb, 256) int8, "scale": (..., nb, 1) float32}``), about
2.03 bytes a parameter against 8 for float32.  Moments are dequantized,
updated with the fresh gradient and re-quantized every step, as in 8-bit
Adam minus the dynamic-tree format.  Codes round half to even
(``torch.round``, as ``jnp.round``), so both packages store the same
codes for the same moments.

Every update is float32 arithmetic in the reference's order: the global
gradient norm over the leaves in tree order, clipping by it, bias
correction by ``b ** count``, decay only on leaves with ``ndim >= 2``
(matrices, not norms or biases), and the new parameter cast back to the
leaf's type (from the float32 master copy when ``master_weights``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.meshes import gather_dim
from repro_torch.tree import leaves, tree_map, tree_pick

BLOCK = 256


# ---------------------------------------------------------------------------
# Blockwise int8 quantization
# ---------------------------------------------------------------------------


def _q8(x: torch.Tensor, out=None) -> Dict[str, torch.Tensor]:
    """Blockwise int8 along the last axis only (the reference's layout:
    leading dimensions keep their sharding); written into ``out``'s
    ``q`` and ``scale`` where given."""
    last = x.shape[-1] if x.dim() else 1
    xb = x if x.dim() else x.reshape(1)
    pad = (-last) % BLOCK
    if pad:
        xb = F.pad(xb, (0, pad))
    nb = xb.shape[-1] // BLOCK
    blocks = xb.reshape(*xb.shape[:-1], nb, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    q = (blocks / torch.clamp(scale, min=1e-12)).round_()
    if out is None:
        return {"q": q.to(torch.int8), "scale": scale.to(torch.float32)}
    out["q"].copy_(q)
    out["scale"].copy_(scale)
    return out


def _dq8(qs: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    blocks = qs["q"].to(torch.float32) * qs["scale"]
    padded = blocks.shape[-2] * blocks.shape[-1]
    flat_last = blocks.reshape(*blocks.shape[:-2], padded)
    last = shape[-1] if len(shape) else 1
    return flat_last[..., :last].reshape(shape)


def _splits_alike(s, ms, shape) -> bool:
    """Whether a moment with sharding ``ms`` is split as the leaf (shape
    ``shape``) is under ``s``: always for float moments (one ZeRO spec on
    one shape); for int8 codes, when ``q`` and ``scale`` split the leaf's
    dimension (a leading one, or the block axis of a last dimension that
    is whole blocks)."""
    if not isinstance(ms, dict):
        return True
    d = s.dim
    q, sc = ms["q"].dim, ms["scale"].dim
    if d is None:
        return q is None and sc is None
    return q == d and sc == d and (d < len(shape) - 1 or shape[-1] % BLOCK == 0)


def _land(dst, src):
    """``src`` written into ``dst``'s storage (a tensor, or an int8
    moment's ``{q, scale}``); returns ``dst``."""
    if isinstance(dst, dict):
        for k in dst:
            _land(dst[k], src[k])
    elif src is not dst:
        dst.copy_(src)
    return dst


def _whole_codes(x: torch.Tensor, mesh) -> Dict[str, torch.Tensor]:
    """The int8 codes of the whole leaf whose last dimension is split over
    ``mesh``'s model group, from this rank's columns ``x``: the columns
    gathered over the group and quantized whole, as the blocks of 256 run
    across the ranks' columns.  Every rank of the group gets the same
    codes."""
    return _q8(gather_dim(x, x.dim() - 1, mesh.model_group, mesh.n_model))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: str = "float32"  # float32 | bfloat16 | int8
    clip_norm: float = 1.0
    # float32 master copies of the parameters in the optimizer state; the
    # parameters are the master cast to their type after every update
    master_weights: bool = False


class AdamW:
    def __init__(self, cfg: AdamWConfig = AdamWConfig()):
        self.cfg = cfg

    # -- state ----------------------------------------------------------
    def _encode(self, x: torch.Tensor, out=None):
        """``x`` in the moments' type, written into ``out`` where given."""
        sd = self.cfg.state_dtype
        if sd == "int8":
            return _q8(x, out)
        if out is None:
            return x.to(torch.bfloat16 if sd == "bfloat16" else torch.float32)
        return _land(out, x)

    def _decode(self, enc, shape) -> torch.Tensor:
        if isinstance(enc, dict) and "q" in enc:
            return _dq8(enc, shape)
        return enc.to(torch.float32)

    def init(self, params) -> dict:
        def zeros(p):
            return self._encode(torch.zeros(p.shape, dtype=torch.float32, device=p.device))

        some = leaves(params)
        dev = some[0].device if some else None
        state = {
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if self.cfg.master_weights:
            state["master"] = tree_map(lambda p: p.to(torch.float32), params)
        return state

    # -- update ----------------------------------------------------------
    def update(self, grads, state: dict, params, lr: torch.Tensor, *,
               grad_shardings=None, opt_shardings=None
               ) -> Tuple[dict, dict, Dict[str, torch.Tensor]]:
        """Returns (new_params, new_state, metrics): the tensors of
        ``params`` and ``state``, the new values written into them (each
        leaf's parameter, master copy and moments as that leaf's update
        lands, ``count`` in place), as the reference's step does into its
        donated buffers.  A leaf holds two float32 temporaries beside
        them.  The caller runs it under ``torch.no_grad()`` and, to keep
        the old state, passes a copy.

        ``grad_shardings``: the ``NamedSharding`` tree the gradients were
        reduced to (``train/step.py``).  On a mesh over ranks each leaf's
        gradient, moments and master copy are this rank's share along the
        sharding's ``dim`` (the ZeRO layout of ``opt_shardings``, the
        state's ``NamedSharding`` tree), the parameters are whole: the
        update runs on the share and the new shares are all-gathered into
        the parameters.  The clip norm is global: the leaves' squared
        sums are all-reduced (a replicated leaf counted once), so every
        rank scales by the same number.  Int8 moments whose blocks are
        split otherwise than the gradient (the ZeRO dimension of their
        ``q``/``scale`` is not the leaf's, or splits a block) are updated
        whole on every rank from their gathered codes and keep their own
        share.  Without shardings, or on a mesh of one process, everything
        is whole.

        Where the ``model`` axis spans ranks, the parameters, gradients,
        moments and master copies are each rank's share along ``model``
        too: the update and its all-gathers run over the data group on the
        model-local leaves, and the clip norm sums each leaf's squares over
        the model group where the specs split it and counts it once where
        they do not.  Int8 moments follow the reference's state layout: a
        leaf split over ``model`` along a leading dimension (``wo``, a
        vocab-parallel embedding, experts split over E) has its codes split
        along it too and updates its rows locally; one split along its last
        dimension (``wq``, an FFN's ``gate``/``up``) has codes whole along
        ``model``, the same on every rank of the group
        (``_update_columns``)."""
        cfg = self.cfg
        mesh = None if grad_shardings is None else leaves(grad_shardings)[0].mesh
        if mesh is not None and mesh.group is None:
            mesh = None
        count = state["count"].add_(1)
        sums = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(grads)]
        if mesh is not None and sums:
            # a rank counts the squares it holds alone: a leaf's share over
            # each axis that splits it, the first rank's along one that does not
            own = [(s.dim is not None or mesh.data_index == 0)
                   and (s.mdim is not None or not mesh.model_index)
                   for s in leaves(grad_shardings)]
            sums = list(mesh.model_sum(mesh.sum(torch.stack(
                [x if o else torch.zeros_like(x) for x, o in zip(sums, own)]))).unbind())
        sq = torch.zeros((), dtype=torch.float32, device=count.device)
        for x in sums:
            sq = sq + x
        gnorm = torch.sqrt(sq)
        if cfg.clip_norm:
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        else:
            scale = 1.0
        countf = count.to(torch.float32)
        b1c = 1.0 - torch.pow(cfg.b1, countf)
        b2c = 1.0 - torch.pow(cfg.b2, countf)
        use_master = cfg.master_weights and "master" in state
        masters = state.get("master", params)

        def upd(p, g, m_enc, v_enc, master, encode=True):
            # the reference's formula, its operations in its order (a
            # product's operands swapped at most), each in place; the new
            # parameter, master copy and (with ``encode``) moments land in
            # the tensors given, every read of them done first
            g = g.to(torch.float32) * scale
            m = self._decode(m_enc, p.shape).mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v = self._decode(v_enc, p.shape).mul_(cfg.b2).add_(
                torch.square(g).mul_(1 - cfg.b2))
            del g
            step = torch.div(m, b1c).div_(torch.div(v, b2c).sqrt_().add_(cfg.eps))
            p32 = (master if use_master else p).to(torch.float32)
            if cfg.weight_decay and p.dim() >= 2:  # decay matrices, not norms/bias
                step.add_(cfg.weight_decay * p32)
            new_master = p32.sub_(step.mul_(lr))
            del step
            if encode:
                m, v = self._encode(m, m_enc), self._encode(v, v_enc)
            return _land(p, new_master), m, v, (new_master if use_master else None)

        def put(specs, new, given):
            # this rank's share of each whole new tensor, into its given one
            return tree_map(lambda sh, t, d: _land(d, sh.place(t)), specs, new, given)

        if mesh is None:
            out = tree_map(upd, params, grads, state["m"], state["v"], masters)
        else:
            def upd_share(s, p, g, m_enc, v_enc, master, ms, vs):
                master = master if use_master else None
                if isinstance(ms, dict) and s.mdim is not None and s.mdim == p.dim() - 1:
                    return self._update_columns(upd, put, s, p, g, m_enc, v_enc, master, ms, vs)
                # the leaves (and a row-split leaf's codes) are model-local:
                # only their data split is left
                s = s.data_part
                if isinstance(ms, dict):
                    ms = tree_map(lambda sh: sh.data_part, ms)
                    vs = tree_map(lambda sh: sh.data_part, vs)
                if _splits_alike(s, ms, p.shape):
                    new_p, m, v, nm = upd(s.place(p), g, m_enc, v_enc, master)
                    return s.gather(new_p, out=p), m, v, nm
                # int8 codes split otherwise than the leaf: update it whole
                whole = {k: tree_map(lambda sh, t: sh.gather(t), sp, enc)
                         for k, sp, enc in (("m", ms, m_enc), ("v", vs, v_enc))}
                _, m, v, nm = upd(p, s.gather(g), whole["m"], whole["v"],
                                  s.gather(master) if use_master else None)
                return (p, put(ms, m, m_enc), put(vs, v, v_enc),
                        put(s, nm, master) if use_master else None)

            out = tree_map(upd_share, grad_shardings, params, grads, state["m"], state["v"],
                           masters, opt_shardings["m"], opt_shardings["v"])
        new_state = {"m": tree_pick(out, 1), "v": tree_pick(out, 2), "count": count}
        if use_master:
            new_state["master"] = tree_pick(out, 3)
        return tree_pick(out, 0), new_state, {"grad_norm": gnorm}

    @staticmethod
    def _update_columns(upd, put, s, p, g, m_enc, v_enc, master, ms, vs):
        """``update`` of a leaf whose last dimension is split over the
        model group (``s.mdim``), with int8 moments, whose codes the specs
        keep whole along ``model`` (the reference's ``opt_state_specs``).
        The rank updates its own columns: from its blocks of the codes
        where its width is whole blocks (its columns then start at a block
        boundary too), else from the whole moments decoded; the new
        moments' codes are then made whole again on every rank of the
        group (:func:`_whole_codes`) and land in the codes the rank holds.
        The data split is handled as in ``update``: locally where the
        codes split over ``data`` as the leaf does, else from the codes
        gathered over the data group."""
        mesh = s.mesh
        k, i = p.shape[-1], mesh.model_index
        aligned = k % BLOCK == 0
        s = s.data_part

        def own(enc):
            # the rank's columns of a moment: its blocks, or the decoded columns
            if aligned:
                return {key: t.narrow(-2, i * (k // BLOCK), k // BLOCK) for key, t in enc.items()}
            lead = enc["q"].shape[:-2]
            return _dq8(enc, (*lead, mesh.n_model * k)).narrow(-1, i * k, k)

        def whole(x):
            if aligned:  # codes of whole blocks: join them along the block axis
                return {key: gather_dim(t, t.dim() - 2, mesh.model_group, mesh.n_model)
                        for key, t in _q8(x).items()}
            return _whole_codes(x, mesh)

        if _splits_alike(s, ms, p.shape):
            new_p, m, v, nm = upd(s.place(p), g, own(m_enc), own(v_enc), master, encode=False)
            return s.gather(new_p, out=p), _land(m_enc, whole(m)), _land(v_enc, whole(v)), nm
        gathered = [tree_map(lambda sh, t: sh.gather(t), sp, enc)
                    for sp, enc in ((ms, m_enc), (vs, v_enc))]
        _, m, v, nm = upd(p, s.gather(g), own(gathered[0]), own(gathered[1]),
                          None if master is None else s.gather(master), encode=False)
        return (p, put(ms, whole(m), m_enc), put(vs, whole(v), v_enc),
                None if nm is None else put(s, nm, master))

    def state_bytes_per_param(self) -> float:
        return {"float32": 8.0, "bfloat16": 4.0, "int8": 2.0 + 8.0 / BLOCK}[
            self.cfg.state_dtype
        ]

