"""Batched Eq. (1) score reduction + tie-broken argmin (PyTorch + CUDA).

Twin of ``repro.kernels.score_reduce``.  The engine's candidate set for
one scheduling event is a (B, S) block of per-slot energy deviations and
unit counts (``ScoredBatch.padded_cols``), optionally DVFS frequency
levels (``ScoredBatch.padded_f``).  Scoring it is the row reduction

    S[b] = Σ_s dev[b, s] / max(n[b], 1) + λ·(G_free − Σ_s g[b, s]) / M
           + λ_f·Σ_s f[b, s] / max(n[b], 1) + bias[b]

with +inf where ``mask`` is 0, followed by the argmin under EcoSched's
tie-break: lowest score, then largest total unit count, then earliest
row; -1 when no row is feasible.

``score_reduce(..., guard=g)`` also returns, from the same pass, the
argmin over the rows that ``g`` admits as well (a value > 0): exactly
what a second call with ``mask=mask & g`` would return.  EcoSched's
idle-node guard (take the best non-empty action when the empty action
wins on an idle node) needs both winners, and gets them from one launch
and one read of two ints.

``score_reduce_batch`` reduces many nodes' blocks in one launch (the
fleet path's same-instant bursts) and ``score_reduce_multi`` many small
windows; both take the rows of all their nodes or windows packed on the
row axis (``pack_windows``), and each node's or window's result is
bitwise that of a solo ``score_reduce`` on its rows.  With a ``guard``
plane they also return, from the same launch, each segment's argmin over
the rows the guard admits as well, so the fleet's idle nodes get both
winners of their guard from the burst's one launch.

Each function has two versions here.  On a CUDA tensor the wrapper
launches the hand-written kernel of ``csrc/score_reduce.cu`` (built at
first use by ``_build``) or raises; it never falls back.  On a CPU tensor
it runs the plain PyTorch version, which sums the slot columns left to
right in float32 and applies the kernel's operation order, so the two
agree bitwise on the card.  Only a kernel launch counts in ``STATS``.

Unlike the reference, nothing is padded: rows and slots go to the kernel
as they are (the reference's power-of-two rows and 8-slot padding served
the TPU's tiling and its jit cache).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

_ROWS_PER_BLOCK = 8192  # score_reduce's rows per block (csrc kRowsPerBlock)
# per device: the zeroed int ticket of the multi-block combine, and the
# pinned host ints the winners are copied into (grown to the widest burst)
_TICKETS: Dict[torch.device, torch.Tensor] = {}
_HOST_WINNERS: Dict[torch.device, torch.Tensor] = {}


@dataclass
class KernelStats:
    """Launches of one kernel, and the rows they reduced."""

    launches: int = 0
    rows: int = 0
    max_rows: int = 0
    windows: int = 0  # nodes or windows reduced (1 per solo launch)
    max_windows: int = 0
    guarded: int = 0  # segments (a solo call is one) that carried a guard

    def add(self, rows: int, windows: int = 1, guarded: int = 0) -> None:
        self.launches += 1
        self.guarded += int(guarded)
        self.rows += rows
        self.max_rows = max(self.max_rows, rows)
        self.windows += windows
        self.max_windows = max(self.max_windows, windows)


STATS: Dict[str, KernelStats] = {
    "score_reduce": KernelStats(),
    "score_reduce_batch": KernelStats(),
    "score_reduce_multi": KernelStats(),
}


def reset_stats() -> None:
    for name in STATS:
        STATS[name] = KernelStats()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_block(dev, g, n, f, bias, mask, guard=None) -> Tuple[int, int]:
    """Validate a (B, S) block and its (B,) columns; returns (B, S)."""
    if not isinstance(dev, torch.Tensor) or dev.dim() != 2:
        raise TypeError("dev must be a (B, S) torch tensor")
    B, S = dev.shape
    for name, t, shape in (
        ("dev", dev, (B, S)), ("g", g, (B, S)), ("f", f, (B, S)),
        ("n", n, (B,)), ("bias", bias, (B,)), ("mask", mask, (B,)),
        ("guard", guard, (B,)),
    ):
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev.device:
            raise ValueError(f"{name} is on {t.device}, dev on {dev.device}")
    return B, S


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the definition; the CPU path)
# ---------------------------------------------------------------------------


def _row_scores_plain(dev, g, f, n, bias, mask, lam, g_free, M, lam_f):
    """Per-row (scores, Σg) in the kernel's order of operations.  ``lam``
    .. ``lam_f`` are float32 tensors broadcastable to (B,) on the block's
    device — never Python or host scalars, which the card's division
    would turn into a reciprocal multiply."""
    B, S = dev.shape
    sd = torch.zeros(B, dtype=torch.float32, device=dev.device)
    sg = torch.zeros_like(sd)
    sf = torch.zeros_like(sd)
    for s in range(S):  # left to right, as the kernel sums
        sd = sd + dev[:, s]
        sg = sg + g[:, s]
        if f is not None:
            sf = sf + f[:, s]
    n_eff = torch.clamp(n, min=1.0)
    v = sd / n_eff + (lam * (g_free - sg)) / M + (lam_f * sf) / n_eff
    if bias is not None:
        v = v + bias
    if mask is not None:
        v = torch.where(mask > 0, v, torch.full_like(v, float("inf")))
    return v, sg


def _pick_plain(scores: torch.Tensor, tot: torch.Tensor) -> int:
    """Tie-broken argmin: min score, then max Σg, then min row; -1 when
    nothing is feasible (empty or all +inf)."""
    if scores.numel() == 0:
        return -1
    m = scores.min()
    if torch.isinf(m):
        return -1
    tie = scores == m
    t_best = torch.where(tie, tot, torch.full_like(tot, -1.0)).max()
    return int(torch.nonzero(tie & (tot == t_best))[0, 0])


def score_reduce_plain(dev, g, n, *, lam, g_free, M, f=None, lam_f=0.0,
                       bias=None, mask=None, guard=None):
    """Plain PyTorch version of :func:`score_reduce` (same arguments and
    result): with ``guard``, what a second call with ``mask & guard``
    returns is its third item."""
    _check_block(dev, g, n, f, bias, mask, guard)
    p = torch.tensor([lam, g_free, M, lam_f], dtype=torch.float32,
                     device=dev.device)
    scores, tot = _row_scores_plain(dev, g, f, n, bias, mask, p[0], p[1],
                                    p[2], p[3])
    if guard is None:
        return scores, _pick_plain(scores, tot)
    return scores, _pick_plain(scores, tot), _pick_guarded_plain(scores, tot, guard)


def _pick_guarded_plain(scores, tot, guard) -> int:
    """The tie-broken argmin over the rows ``guard`` also admits."""
    return _pick_plain(
        torch.where(guard > 0, scores, torch.full_like(scores, float("inf"))), tot)


def score_reduce_multi_plain(dev, g, n, offsets, params, *, f=None,
                             bias=None, mask=None, guard=None, guarded=None):
    """Plain PyTorch version of :func:`score_reduce_multi` (same arguments
    and result)."""
    _check_block(dev, g, n, f, bias, mask, guard)
    off, W = _check_windows(offsets, params, dev)
    lo, hi = off[:-1], off[1:]
    wid = torch.repeat_interleave(
        torch.arange(W, device=dev.device), (hi - lo).to(torch.int64)
    )
    rp = params.index_select(0, wid)  # per-row [λ, G_free, M, λ_f]
    scores, tot = _row_scores_plain(dev, g, f, n, bias, mask, rp[:, 0],
                                    rp[:, 1], rp[:, 2], rp[:, 3])
    bests, bests_g = [], []
    for a, b in zip(lo.tolist(), hi.tolist()):
        bests.append(_pick_plain(scores[a:b], tot[a:b]))
        if guard is not None:
            bests_g.append(_pick_guarded_plain(scores[a:b], tot[a:b], guard[a:b]))
    return (scores, bests) if guard is None else (scores, bests, bests_g)


def score_reduce_batch_plain(dev, g, n, offsets, params, *, f=None,
                             bias=None, mask=None, guard=None, guarded=None):
    """Plain PyTorch version of :func:`score_reduce_batch`: one solo
    reduction per node, each with its own params row."""
    _check_block(dev, g, n, f, bias, mask, guard)
    off, D = _check_windows(offsets, params, dev)
    bounds = off.tolist()
    parts, bests, bests_g = [], [], []
    for d in range(D):
        rows = slice(bounds[d], bounds[d + 1])
        p = params[d]
        s, tot = _row_scores_plain(
            dev[rows], g[rows], None if f is None else f[rows], n[rows],
            None if bias is None else bias[rows],
            None if mask is None else mask[rows], p[0], p[1], p[2], p[3],
        )
        parts.append(s)
        bests.append(_pick_plain(s, tot))
        if guard is not None:
            bests_g.append(_pick_guarded_plain(s, tot, guard[rows]))
    scores = (torch.cat(parts) if parts else
              torch.empty(0, dtype=torch.float32, device=dev.device))
    return (scores, bests) if guard is None else (scores, bests, bests_g)


# ---------------------------------------------------------------------------
# Wrappers: the CUDA kernel on a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------


def score_reduce(dev, g, n, *, lam, g_free, M, f=None, lam_f=0.0,
                 bias=None, mask=None, guard=None):
    """Scores + tie-broken argmin for a (B, S) candidate block.

    ``dev``/``g`` (and the optional frequency plane ``f``, weighted by
    ``lam_f``) are (B, S) float32 slot columns, zero past each action's
    size ``n`` (B,); ``bias`` is an optional per-row additive term and
    ``mask`` (B,) marks feasible rows with a value > 0 (default: all).
    All tensors lie on one device.  Returns (float32 scores (B,), winning
    row) — the row is -1 when no candidate is feasible.  With ``guard``
    (B,) it returns (scores, winning row, guarded winning row), the last
    the argmin over the rows ``mask`` and ``guard`` both admit (-1 when
    there is none), from the same launch.

    On the card a call is one launch, one device allocation (the scores
    and both winners in one buffer; above 8192 rows also the per-block
    scratch) and one copy of the two winners into the device's pinned
    host ints, with a stream sync, inside the same C call.  The ticket
    and the host ints are per device, so calls on one device are made
    from one thread.
    """
    B, S = _check_block(dev, g, n, f, bias, mask, guard)
    if _device_kind(dev) == "cpu":
        return score_reduce_plain(dev, g, n, lam=lam, g_free=g_free, M=M,
                                  f=f, lam_f=lam_f, bias=bias, mask=mask,
                                  guard=guard)
    if B == 0:
        scores = torch.empty(0, dtype=torch.float32, device=dev.device)
        return (scores, -1) if guard is None else (scores, -1, -1)
    from repro_torch.kernels._build import library

    nb = -(-B // _ROWS_PER_BLOCK)
    out = torch.empty(B + 2 + (6 * nb if nb > 1 else 0), dtype=torch.float32,
                      device=dev.device)
    ticket = _ticket(dev.device) if nb > 1 else None
    host = _host_winners(dev.device, 2)
    stream = torch.cuda.current_stream(dev.device).cuda_stream
    # the launch, the copy of the two winners into pinned host memory and
    # the stream sync, all in the one C call
    err = library().score_reduce_launch(
        _ptr(dev), _ptr(g), _ptr(f), _ptr(n), _ptr(bias), _ptr(mask),
        _ptr(guard), B, S, float(lam), float(g_free), float(M), float(lam_f),
        out.data_ptr(), _ptr(ticket), host.data_ptr(), ctypes.c_void_p(stream),
    )
    _raise_on(err, "score_reduce launch")
    STATS["score_reduce"].add(B, guarded=guard is not None)
    best, best_guard = host[:2].tolist()
    scores = out[:B]
    return (scores, best) if guard is None else (scores, best, best_guard)


def _ticket(device: torch.device) -> torch.Tensor:
    """The device's zeroed int ticket (the kernel's last block resets it)."""
    if device not in _TICKETS:
        _TICKETS[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[device]


def _check_windows(offsets, params, dev) -> Tuple[torch.Tensor, int]:
    if offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise TypeError("offsets must be a 1-D int32 tensor")
    W = offsets.shape[0] - 1
    if W < 0:
        raise ValueError("offsets needs at least one entry")
    if params.dtype != torch.float32 or tuple(params.shape) != (W, 4):
        raise ValueError(f"params must be float32 of shape ({W}, 4)")
    for name, t in (("offsets", offsets), ("params", params)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev.device:
            raise ValueError(f"{name} is on {t.device}, dev on {dev.device}")
    return offsets, W


def _host_winners(device: torch.device, n: int) -> torch.Tensor:
    """The device's pinned host ints the winners are copied into, at
    least ``n`` long (grown to the widest burst)."""
    buf = _HOST_WINNERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 64, 0 if buf is None else 2 * buf.numel()),
                          dtype=torch.int32, pin_memory=True)
        _HOST_WINNERS[device] = buf
    return buf


def _launch_segments(name, dev, g, n, offsets, params, f, bias, mask, guard,
                     guarded):
    """The single-pass kernel shared by :func:`score_reduce_multi` and
    :func:`score_reduce_batch`: one block per packed segment (window or
    node) of any size, one device allocation for the scores and both
    winners of every segment, and the winners copied into pinned host
    memory inside the same C call.  Counts the launch under ``name``."""
    R, S = dev.shape
    W = params.shape[0]
    if W == 0:
        scores = torch.empty(R, dtype=torch.float32, device=dev.device)
        return (scores, []) if guard is None else (scores, [], [])
    from repro_torch.kernels._build import library

    out = torch.empty(R + 2 * W, dtype=torch.float32, device=dev.device)
    host = _host_winners(dev.device, 2 * W)
    stream = torch.cuda.current_stream(dev.device).cuda_stream
    err = library().score_reduce_multi_launch(
        _ptr(dev), _ptr(g), _ptr(f), _ptr(n), _ptr(bias), _ptr(mask),
        _ptr(guard), _ptr(offsets), _ptr(params), W, R, S, out.data_ptr(),
        host.data_ptr(), ctypes.c_void_p(stream),
    )
    _raise_on(err, f"{name} launch")
    STATS[name].add(R, W, guarded=0 if guard is None else
                    W if guarded is None else guarded)
    if guard is None:
        return out[:R], host[:W].tolist()
    both = host[:2 * W].tolist()
    return out[:R], both[:W], both[W:]


def score_reduce_multi(dev, g, n, offsets, params, *, f=None, bias=None,
                       mask=None, guard=None, guarded=None):
    """Reduce many candidate windows packed on the row axis in one launch.

    Window ``w`` owns rows ``offsets[w]:offsets[w+1]`` of the (R, S)
    block (``offsets`` int32, (W+1,), non-decreasing from 0 to R) and
    scores with its own ``params[w] = [λ, G_free, M, λ_f]`` (float32,
    (W, 4)).  Every window's scores and winner are bitwise those of a solo
    :func:`score_reduce` on its rows.  Returns (scores (R,), one
    window-local winning row per window, -1 for an empty or all-infeasible
    window).  With ``guard`` (R,) it returns (scores, winners, guarded
    winners), the last each window's winner over the rows ``mask`` and
    ``guard`` both admit (-1 where none: a window whose guard rows are all
    0 carries no guard), from the same launch; ``guarded`` is the number
    of windows that carried one, for ``STATS`` (default: all of them).
    :func:`pack_windows` builds the arguments from request dicts.
    """
    _check_block(dev, g, n, f, bias, mask, guard)
    _check_windows(offsets, params, dev)
    if _device_kind(dev) == "cpu":
        return score_reduce_multi_plain(dev, g, n, offsets, params, f=f,
                                        bias=bias, mask=mask, guard=guard)
    return _launch_segments("score_reduce_multi", dev, g, n, offsets, params,
                            f, bias, mask, guard, guarded)


def score_reduce_batch(dev, g, n, offsets, params, *, f=None, bias=None,
                       mask=None, guard=None, guarded=None):
    """Reduce many nodes' candidate blocks in one launch.

    The arguments are :func:`score_reduce_multi`'s (``pack_windows``
    builds them): node ``d`` owns rows ``offsets[d]:offsets[d+1]`` and
    scores with ``params[d] = [λ, G_free, M, λ_f]``.  The kernel gives
    each node one block that loops over its rows, so no node size has to
    be known ahead.  Returns (scores (R,), one node-local winning row per
    node, -1 for an empty or all-infeasible node), each node bitwise a
    solo :func:`score_reduce`; with ``guard`` also each node's guarded
    winner, as :func:`score_reduce_multi` does.
    """
    _check_block(dev, g, n, f, bias, mask, guard)
    _check_windows(offsets, params, dev)
    if _device_kind(dev) == "cpu":
        return score_reduce_batch_plain(dev, g, n, offsets, params, f=f,
                                        bias=bias, mask=mask, guard=guard)
    return _launch_segments("score_reduce_batch", dev, g, n, offsets, params,
                            f, bias, mask, guard, guarded)


def pack_windows(reqs: Sequence[Dict[str, Any]], device) -> Dict[str, Any]:
    """Pack request dicts into :func:`score_reduce_multi`'s (and
    :func:`score_reduce_batch`'s) arguments on
    ``device`` — the reference's request shape: numpy ``dev``/``g`` (B, S),
    ``n`` (B,), scalars ``lam``/``g_free``/``M``, optional ``f``/``lam_f``/
    ``bias``/``mask``, and optional ``guard`` (B,) (rows of requests
    without one are 0, so they give no guarded winner; ``guarded`` counts
    the requests with one).  Windows concatenate on the row axis,
    zero-padded to the widest S (appended zeros add exactly +0.0 to every
    slot sum); the float planes, the columns, the params and the int32
    offsets share one host buffer, so the upload is one copy."""
    sizes = [r["dev"].shape for r in reqs]
    R = sum(b for b, _ in sizes)
    S = max((s for _, s in sizes), default=1) or 1
    W = len(reqs)
    has_f = any(r.get("f") is not None for r in reqs)
    optional = [k for k in ("bias", "mask", "guard")
                if any(r.get(k) is not None for r in reqs)]
    n_planes = 3 if has_f else 2
    n_cols = 1 + len(optional)
    at = n_planes * R * S  # the columns, then params, then offsets
    buf = np.zeros(at + n_cols * R + 4 * W + W + 1, dtype=np.float32)
    planes = buf[:at].reshape(n_planes, R, S)
    cols = buf[at:at + n_cols * R].reshape(n_cols, R)
    p_at = at + n_cols * R
    params = buf[p_at:p_at + 4 * W].reshape(W, 4)
    offsets = buf[p_at + 4 * W:].view(np.int32)
    off = 0
    for k, r in enumerate(reqs):
        B, s = sizes[k]
        rows = slice(off, off + B)
        planes[0, rows, :s] = r["dev"]
        planes[1, rows, :s] = r["g"]
        if has_f and r.get("f") is not None:
            planes[2, rows, :s] = r["f"]
        cols[0, rows] = np.asarray(r["n"], dtype=np.float32).reshape(B)
        for c, key in enumerate(optional, start=1):
            v = r.get(key)
            if v is not None:
                cols[c, rows] = np.asarray(v, dtype=np.float32).reshape(B)
            elif key == "mask":
                cols[c, rows] = 1.0  # no mask: every row feasible
        params[k] = [r["lam"], r["g_free"], r["M"], r.get("lam_f", 0.0)]
        off += B
        offsets[k + 1] = off
    dbuf = torch.from_numpy(buf).to(device)
    out = dict(
        dev=dbuf[:R * S].view(R, S),
        g=dbuf[R * S:2 * R * S].view(R, S),
        f=dbuf[2 * R * S:3 * R * S].view(R, S) if has_f else None,
        n=dbuf[at:at + R],
        params=dbuf[p_at:p_at + 4 * W].view(W, 4),
        offsets=dbuf[p_at + 4 * W:].view(torch.int32),
    )
    for key in ("bias", "mask", "guard"):
        c = optional.index(key) + 1 if key in optional else None
        out[key] = None if c is None else dbuf[at + c * R:at + (c + 1) * R]
    if "guard" in optional:
        out["guarded"] = sum(r.get("guard") is not None for r in reqs)
    return out
