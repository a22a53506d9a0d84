#!/usr/bin/env python3
"""Count the packed score-reduce launches of ``chip_smoke.py``'s two
256-node fleet cells, by round, on the CPU.

    PYTHONPATH=src python3 tools/fleet_launch_counts.py

Each cell's batched legs (hierarchical and flat dispatch) run through
``chip_smoke.fleet_leg`` with ``EcoSched(engine="torch", device="cpu")``,
so the kernels' plain versions run and the wrappers count no launch.
Counting stand-ins for the names ``repro_torch.core.cluster`` calls
(``score_reduce_batch``, ``score_reduce_multi``) count one launch per
call instead, and split the calls into first-round calls and
second-round calls: a call whose requests came back from
``EcoSched.stage_round1`` (the idle-node guard's masked re-score, where a
tree still makes one).  They also count the guarded segments each call
carried.  ``score_reduce_multi`` launches that a node's own
``propose_resizes`` makes outside the bursts are counted apart.  Which
launches the coordinator makes is decided on the host, so
these are the counts a run on the card makes.  Prints one JSON line.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    import repro_torch.core.cluster as CL
    import repro_torch.core.ecosched as E
    from repro_torch.core.ecosched import EcoSched

    second_ids, current = set(), {"round": 1, "guarded": 0}
    counts = {}
    real_round1 = EcoSched.stage_round1
    real_pack = CL.pack_windows

    def round1(self, *a, **kw):
        req2 = real_round1(self, *a, **kw)
        if req2 is not None:
            second_ids.add(id(req2))
        return req2

    def pack(reqs, device):
        current["round"] = 2 if any(id(r) in second_ids for r in reqs) else 1
        current["guarded"] = sum(r.get("guard") is not None for r in reqs)
        return real_pack(reqs, device)

    def counting(mod, name, key):
        real = getattr(mod, name)

        def launch(*a, **kw):
            if mod is E:  # a node's own resize table, outside the bursts
                counts[key] = counts.get(key, 0) + 1
                return real(*a, **kw)
            c = counts.setdefault(key, {"round1": 0, "round2": 0, "guarded_segments": 0})
            c[f"round{current['round']}"] += 1
            c["guarded_segments"] += current["guarded"]
            return real(*a, **kw)

        return launch

    EcoSched.stage_round1 = round1
    CL.pack_windows = pack
    for name in ("score_reduce_batch", "score_reduce_multi"):
        setattr(CL, name, counting(CL, name, name))
    E.score_reduce_multi = counting(E, "score_reduce_multi", "score_reduce_multi_node_resize")
    out = {}
    for cell in ("arrivals", "elastic"):
        for hier in (True, False):
            counts = {}
            second_ids.clear()
            res, _, _, _ = chip_smoke.fleet_leg(cell, "torch", torch.device("cpu"), hier=hier)
            out[f"fleet_{cell}_n{chip_smoke.FLEET_NODES} {'hier' if hier else 'flat'}"] = dict(
                counts, fp=chip_smoke.fleet_fp(res)[0])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
