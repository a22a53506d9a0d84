"""A family added as a module of its own goes through every hook of
``family.py`` with no file of the harness edited: a tiny family defined
here, put in ``sys.modules`` as ``families.tinymix``, with two kinds of
layer (attention at some layers, a gated running-mean mixer at the
others, each kind its own stacks), a top-k routed FFN whose experts are
held in part on this chip beside an ungated shared expert, and scales on
the embedding, the residual branches and the logits.  Its weights, its
reference prefill and training steps (on one card and spread over
several), its cache layout and its work counts are checked on the CPU."""
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import perfbench_tiny  # noqa: E402,F401  (puts the benchmark on sys.path)

import control  # noqa: E402
import flops  # noqa: E402
import tokens as T  # noqa: E402
import weights as W  # noqa: E402
from kinds import prefill as kp  # noqa: E402
from reference import train as rt  # noqa: E402
from reference import train_int8 as ri  # noqa: E402
from reference.model import Decoder, fp8_mm, rms  # noqa: E402
from reference.prefill import prefill as ref_prefill  # noqa: E402

CPU = torch.device("cpu")
CFG = dict(name="tinymix", family="tinymix", num_layers=4, attn_layers=[1, 3], d_model=32,
           num_heads=4, num_kv_heads=2, head_dim=8, rope_theta=0.0, sliding_window=0,
           mix_dim=48, num_experts=8, experts_held=[0, 1, 2, 3], top_k=2, expert_ff=16,
           shared_ff=24, vocab_size=61, norm_eps=1e-6, dtype="float32", tie_embeddings=True,
           embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=16.0)
CALLED = set()


def _kind(cfg, li):
    """(kind of layer li, its entry in that kind's stacks)."""
    kinds = ["attn" if i in cfg["attn_layers"] else "mix" for i in range(cfg["num_layers"])]
    return kinds[li], kinds[:li].count(kinds[li])


def _pick(tree, j):
    return {k: _pick(v, j) for k, v in tree.items()} if isinstance(tree, dict) else tree[j]


def draw(cfg, gen, dt, device):
    from families import dense

    n_attn = len(cfg["attn_layers"])
    n_mix, d, m = cfg["num_layers"] - n_attn, cfg["d_model"], cfg["mix_dim"]
    blocks = dense.draw(dict(cfg, num_layers=n_attn), gen, dt, device)
    blocks["mix"] = {"ln": W.zeros(device, dt, n_mix, d), "w_in": W.dense(gen, n_mix, d, m, dt),
                     "w_gate": W.dense(gen, n_mix, d, m, dt),
                     "w_out": W.dense(gen, n_mix, m, d, dt)}
    return blocks


def draw_ffn(cfg, gen, dt, device):
    CALLED.add("draw_ffn")
    L, d, E = cfg["num_layers"], cfg["d_model"], cfg["num_experts"]
    f, fs, held = cfg["expert_ff"], cfg["shared_ff"], len(cfg["experts_held"])
    return {"moe_ln": W.zeros(device, dt, L, d),
            "moe": {"router": W.dense(gen, L, d, E, dt),
                    "gate": W.normal(gen, (L, held, d, f), d ** -0.5, dt),
                    "up": W.normal(gen, (L, held, d, f), d ** -0.5, dt),
                    "down": W.normal(gen, (L, held, f, d), f ** -0.5, dt)},
            "shared": {"gate": W.dense(gen, L, d, fs, dt), "up": W.dense(gen, L, d, fs, dt),
                       "down": W.dense(gen, L, fs, d, dt)}}


def layer_params(dec, li):
    CALLED.add("layer_params")
    kind, j = _kind(dec.cfg, li)
    b = dec.p["blocks"]
    return {kind: _pick(b[kind], j), "moe_ln": b["moe_ln"][li], "moe": _pick(b["moe"], li),
            "shared": _pick(b["shared"], li)}


def mix(dec, mp, h):
    """A gated causal running mean: its state the last position's mean."""
    x = rms(h, mp["ln"], dec.eps)
    a = dec.mm(x, mp["w_in"])
    s = torch.cumsum(a, dim=1) / torch.arange(1, a.shape[1] + 1, dtype=a.dtype)[:, None]
    g = dec.mm(x, mp["w_gate"])
    return dec.mm(s * torch.sigmoid(g), mp["w_out"]), {"h": s[:, -1]}


def mixer(dec, lp, h):
    from families import dense

    return dense.mixer(dec, lp, h) if "attn" in lp else mix(dec, lp["mix"], h)


def layer(dec, lp, h):
    CALLED.add("layer")
    r = dec.cfg["residual_multiplier"]
    out, cache = mixer(dec, lp, h)
    h = h + r * out
    return h + r * dec.ffn(lp, h), cache


def swiglu(dec, x, g, u, d):
    return dec.mm(torch.nn.functional.silu(dec.mm(x, g)) * dec.mm(x, u), d)


def ffn(dec, lp, h):
    """Top-k of the router's softmax over all experts, the weights
    renormalised; the experts held here each weigh in where routed; the
    shared expert for every token, ungated."""
    CALLED.add("ffn")
    cfg, moe = dec.cfg, lp["moe"]
    x = rms(h, lp["moe_ln"], dec.eps)
    probs = torch.softmax(dec.mm(x, moe["router"]), dim=-1)
    top, idx = probs.topk(cfg["top_k"], dim=-1)
    top = top / top.sum(-1, keepdim=True)
    out = swiglu(dec, x, lp["shared"]["gate"], lp["shared"]["up"], lp["shared"]["down"])
    for slot, e in enumerate(cfg["experts_held"]):
        weight = (top * (idx == e)).sum(-1, keepdim=True)
        out = out + weight * swiglu(dec, x, moe["gate"][slot], moe["up"][slot], moe["down"][slot])
    return out


def embed_scale(cfg):
    CALLED.add("embed_scale")
    return cfg["embedding_multiplier"]


def logit_scale(cfg):
    CALLED.add("logit_scale")
    return 1.0 / cfg["logits_scaling"]


def weight_macs(cfg):
    from families import dense

    return dense.weight_macs(cfg)


def sequence_macs(cfg, S):
    from families import dense

    return dense.sequence_macs(cfg, S)


def layer_macs(cfg, li, S):
    """The mixer of the layer's kind; the router, the routed experts a
    token uses that are held here (top_k of num_experts, the held share
    of them) and the shared expert."""
    CALLED.add("layer_macs")
    d, E, k = cfg["d_model"], cfg["num_experts"], cfg["top_k"]
    moe = d * E + k * len(cfg["experts_held"]) * 3 * d * cfg["expert_ff"] // E
    moe += 3 * d * cfg["shared_ff"]
    if _kind(cfg, li)[0] == "attn":
        return weight_macs(cfg) + moe, sequence_macs(cfg, S)
    return 3 * d * cfg["mix_dim"] + moe, 0


def cache_keys(cfg):
    CALLED.add("cache_keys")
    return {"k": "cache_err", "v": "cache_err", "h": "state_err"}


def cache_entry(cfg, cache, key, li):
    CALLED.add("cache_entry")
    return cache[key][_kind(cfg, li)[1]]


HOOKS = ("draw_ffn", "layer_params", "layer", "ffn", "embed_scale", "logit_scale",
         "layer_macs", "cache_keys", "cache_entry")


@pytest.fixture(autouse=True)
def tinymix(monkeypatch):
    mod = types.ModuleType("families.tinymix")
    for name in ("draw", "draw_ffn", "layer_params", "mixer", "layer", "ffn", "embed_scale",
                 "logit_scale", "weight_macs", "sequence_macs", "layer_macs", "cache_keys",
                 "cache_entry"):
        setattr(mod, name, globals()[name])
    monkeypatch.setitem(sys.modules, "families.tinymix", mod)
    CALLED.clear()
    yield mod


def _tokens(seed, B=2, S=12, index=0):
    return torch.from_numpy(T.batch(seed, index, B, S, CFG["vocab_size"]))


def test_weights_hold_each_kinds_stacks_and_repeat():
    p = W.draw(CFG, 7, CPU)
    b = p["blocks"]
    assert b["attn"]["wq"].shape[0] == 2 and b["mix"]["w_in"].shape[0] == 2
    assert b["moe"]["gate"].shape == (4, 4, 32, 16) and b["shared"]["down"].shape == (4, 24, 32)
    assert "lm_head" not in p  # tied
    again = W.draw(CFG, 7, CPU)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(W.leaves(p), W.leaves(again)))
    assert "draw_ffn" in CALLED


def test_the_reference_takes_the_familys_layers_and_scales():
    p = W.draw(CFG, 3, CPU)
    tokens = _tokens(3)
    seen = {}
    logits = ref_prefill(CFG, p, tokens, on_layer=lambda li, c: seen.__setitem__(li, dict(c)))
    assert {li: sorted(c) for li, c in seen.items()} == {0: ["h"], 1: ["k", "v"], 2: ["h"],
                                                         3: ["k", "v"]}
    dec = Decoder(CFG, p)
    torch.testing.assert_close(dec.embed(tokens), p["embed"][tokens.long()] * 12.0)
    h = torch.randn(2, 1, 32, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(dec.head(h), rms(h, p["final_norm"], 1e-6) @ p["embed"].T / 16.0)
    assert logits.shape == (2, 61) and torch.isfinite(logits).all()
    assert {"layer_params", "layer", "ffn", "embed_scale", "logit_scale"} <= CALLED


def test_the_cache_is_judged_where_the_family_keeps_it():
    """A cache laid out as a program would hold it (each entry stacked
    over the layers of its kind) is found by ``cache_entry`` layer by
    layer, and the prefill's judge reads each entry under its number;
    the float8 control reads both numbers above zero."""
    p = W.draw(CFG, 5, CPU)
    tokens = _tokens(5)
    caches = {}
    ref_prefill(CFG, p, tokens, on_layer=lambda li, c: caches.__setitem__(li, dict(c)))
    stacked = {key: torch.stack([caches[li][key] for li in sorted(caches) if key in caches[li]])
               for key in ("k", "v", "h")}
    for li, c in caches.items():
        for key in c:
            assert torch.equal(kp.cache_entry(CFG, stacked, key, li), c[key])
    numbers = {}
    ref_prefill(CFG, p, tokens, mm=fp8_mm,
                on_layer=control._judge_against(CFG, caches, numbers))
    assert set(numbers) == {"cache_err", "state_err"}
    assert all(0 < x < 1 for x in numbers.values()), numbers
    assert {"cache_keys", "cache_entry"} <= CALLED


def test_training_reference_over_the_mixed_stacks():
    """Two steps of the plain training reference move every leaf; the
    reference spread over cards (here two CPU "cards", its stacks as
    lists of entries), with float32 moments, no compression and no
    master copy, follows the same steps."""
    p = W.draw(CFG, 9, CPU)
    batches = [_tokens(9, index=i) for i in range(2)]
    opt = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0, lr=1e-2)
    one = rt.train(CFG, p, batches, opt)
    assert all(v > 0 for v in one["grad_norms"].values()), one["grad_norms"]
    assert all(v > 0 for v in one["change_norms"].values())
    spread = ri.train(CFG, p, batches, opt, devices=[CPU, CPU], master=False,
                      moments="float32", compress=False)
    torch.testing.assert_close(spread["losses"], one["losses"], rtol=1e-5, atol=0)
    for k in one["grad_norms"]:
        assert spread["grad_norms"][k] == pytest.approx(one["grad_norms"][k], rel=1e-4), k
        assert spread["change_norms"][k] == pytest.approx(one["change_norms"][k], rel=1e-4), k


def test_work_counts_the_experts_a_token_uses():
    d, E, k, f, fs, m = 32, 8, 2, 16, 24, 48
    moe = d * E + (k * 4 // E) * 3 * d * f + 3 * d * fs  # 1 of the 2 routed experts lands here
    attn = d * (32 + 2 * 16) + 32 * d
    pairs = 12 * 13 // 2
    want = 2 * (3 * 12 * (2 * (attn + moe) + 2 * (3 * d * m + moe))
                + 3 * 2 * 2 * 8 * 4 * pairs + 3 * 12 * d * 61)
    assert flops.forward_flops(CFG, 3, 12, 12) == want
    assert flops.layer_weight_macs(CFG, 0) == 3 * d * m + moe
    assert flops.layer_weight_macs(CFG, 1) == attn + moe


def test_the_expert_shares_add_up_to_the_whole_layer():
    """Two chips holding four experts each: their parts of the FFN, the
    shared expert counted once, add up to the layer with all eight."""
    whole = dict(CFG, experts_held=list(range(8)))
    p = W.draw(whole, 4, CPU)
    dec = Decoder(whole, p)
    lp = dec.layer_params(0)
    h = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(1))
    full = ffn(dec, lp, h)
    parts = []
    for held in ([0, 1, 2, 3], [4, 5, 6, 7]):
        share = dict(lp, moe=dict(lp["moe"], **{w: lp["moe"][w][held] for w in
                                                ("gate", "up", "down")}))
        parts.append(ffn(Decoder(dict(whole, experts_held=held), p), share, h))
    shared = swiglu(dec, rms(h, lp["moe_ln"], 1e-6), lp["shared"]["gate"], lp["shared"]["up"],
                    lp["shared"]["down"])
    torch.testing.assert_close(parts[0] + parts[1] - shared, full, rtol=1e-5, atol=1e-6)


def test_every_hook_was_taken():
    p = W.draw(CFG, 2, CPU)
    seen = {}
    ref_prefill(CFG, p, _tokens(2), on_layer=lambda li, c: seen.__setitem__(li, dict(c)))
    stacked = {"h": [seen[0]["h"], seen[2]["h"]]}
    assert torch.equal(kp.cache_entry(CFG, stacked, "h", 2), seen[2]["h"])
    assert kp.cache_keys(CFG)["h"] == "state_err"
    flops.prefill_flops(CFG, 2, 12)
    assert set(HOOKS) <= CALLED
