"""The plain references against the port's CPU path, at reduced widths
and in float32: the prefill's last logits and every layer's cache, and
the training steps' losses, first gradients and changes.  (The test may
import both; the reference itself imports nothing of the port.)"""
import pytest

torch = pytest.importorskip("torch")

from perfbench_tiny import PREFILLS, TRAIN, tiny_config  # noqa: E402

import harness  # noqa: E402
import program as P  # noqa: E402
import tokens as T  # noqa: E402
import weights as W  # noqa: E402
from kinds import train as kt  # noqa: E402
from families import hybrid  # noqa: E402
from reference import train as rt  # noqa: E402
from reference.prefill import prefill as ref_prefill  # noqa: E402

CONFIGS = ["hymba-1.5b", "granite-8b"]
CPU = torch.device("cpu")


def _cfg(name):
    return tiny_config(harness.load_cell(
        {"granite-8b": PREFILLS[0], "hymba-1.5b": PREFILLS[1]}[name]).config, dtype="float32")


def test_weights_have_the_ports_layout():
    for name in CONFIGS:
        cfg = _cfg(name)
        pc = P.model_config(cfg)
        ours = {k: (tuple(t.shape), t.dtype) for k, t in W.leaves(W.draw(cfg, 3, CPU))}
        port = {k: (tuple(t.shape), t.dtype)
                for k, t in W.leaves(P.build_model(pc).init(3, device="cpu"))}
        assert ours == port


def test_weights_repeat_from_the_seed():
    cfg = _cfg("hymba-1.5b")
    a, b = W.draw(cfg, 2**31 + 7, CPU), W.draw(cfg, 2**31 + 7, CPU)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(W.leaves(a), W.leaves(b)))
    c = W.draw(cfg, 2**31 + 8, CPU)
    assert not torch.equal(a["blocks"]["attn"]["wq"], c["blocks"]["attn"]["wq"])


def test_scan_matches_the_recurrence():
    g = torch.Generator().manual_seed(0)
    B, S, nh, hp, N = 2, 37, 3, 4, 5
    x = torch.randn(B, S, nh, hp, generator=g)
    dt = torch.rand(B, S, nh, generator=g) * 0.5
    A = -torch.rand(nh, generator=g) * 2
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N, generator=g)
    y, hT = hybrid.selective_scan(x, dt, A, Bm, Cm, chunk=8)
    h = torch.zeros(B, nh, hp, N)
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + (
            dt[:, t, :, None, None] * x[:, t, :, :, None] * Bm[:, t, None, None, :])
        torch.testing.assert_close(y[:, t], torch.einsum("bhpn,bn->bhp", h, Cm[:, t]),
                                   rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(hT, h, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_matches_the_port(name):
    cfg = _cfg(name)
    pc = P.model_config(cfg)
    params = W.draw(cfg, 11, CPU)
    tokens = torch.from_numpy(T.batch(11, 0, 3, 40, cfg["vocab_size"]))
    model = P.build_model(pc, P.Runtime(attn_impl="pallas", remat="none"))
    with torch.no_grad():
        logits, cache = P.make_prefill(model)(params, {"tokens": tokens})
    seen = []

    def judge(li, c):
        for k, ref in c.items():
            torch.testing.assert_close(cache[k][li].float(), ref, rtol=1e-4, atol=1e-5)
            seen.append(k)

    ref = ref_prefill(cfg, params, tokens, on_layer=judge)
    torch.testing.assert_close(logits[:, -1], ref, rtol=1e-4, atol=1e-4)
    want = {"k", "v", "h", "conv"} if cfg["family"] == "hybrid" else {"k", "v"}
    assert set(seen) == want and len(seen) == len(want) * cfg["num_layers"]


@pytest.mark.parametrize("name", CONFIGS)
def test_training_matches_the_port(name):
    """Three steps of the port's donated step against the reference's:
    losses, each leaf's first clipped gradient (m / (1 - b1)) and each
    leaf's change, in float32 (the configuration's bf16 storage is kept
    by both sides' rounding to the leaf's type, here float32)."""
    cfg = _cfg(name)
    tf = harness.load_cell(TRAIN).traffic
    opt = dict(tf["adamw"], lr=1e-2)
    pc = P.model_config(cfg)
    model = P.build_model(pc, P.Runtime(attn_impl="auto", remat="full"))
    optimizer = P.AdamW(P.AdamWConfig(**tf["adamw"]))
    step = P.make_train_step(model, optimizer, P.Constant(opt["lr"]), donate=True)
    params = W.draw(cfg, 5, CPU)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    batches = [torch.from_numpy(T.batch(5, i, 2, 40, cfg["vocab_size"])) for i in range(3)]
    losses = []
    for i, b in enumerate(batches):
        state, met = step(state, {"tokens": b})
        losses.append(float(met["loss"]))
        if i == 0:
            grads = {k: float(torch.linalg.vector_norm(m)) / (1 - opt["b1"])
                     for k, m in W.leaves(state["opt"]["m"])}
    p0 = W.draw(cfg, 5, CPU)
    change = {k: float(torch.linalg.vector_norm(a - b))
              for (k, a), (_, b) in zip(W.leaves(state["params"]), W.leaves(p0))}
    ref = rt.train(cfg, p0, batches, opt)
    gaps = kt.compare(losses, grads, change, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    here = Path(__file__).resolve().parents[1]
    for path in [*(here / "reference").glob("*.py"), *(here / "families").glob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax", "program",
                                               "harness", "kinds"), (path.name, n)
