"""The port's spans (``repro_torch.trace``) on the CPU, on reduced
hymba-1.5b (attention and the SSD mixer in every layer): nothing is
recorded, and no autograd node is added, unless a profiler runs or
``recording()`` is entered; tracing leaves losses, gradients, new states,
logits and caches the same bit for bit; a call has one root, under remat
``full`` each layer's ``model.attention`` and ``model.ssd`` have a
forward, a recompute and a backward record, and no two of a step's spans
overlap in host order; the root lies inside a ``record_function`` range
around the call, in that range's own profiler times; the ring keeps its
newest records and counts the rest."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig, Constant  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

B, S = 2, 48  # past the reduced window of 32, three SSD chunks of 16
LEAVES = ("model.attention", "model.ssd", "optim.update")


def hymba(remat="full"):
    cfg = reduced(get_config("hymba-1.5b")).replace(dtype="float32")
    return cfg, build_model(cfg, Runtime(remat=remat))


def tokens(cfg, seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}


def train_once(remat):
    """(state, metrics, records) of one pure training step from a fixed
    state, recording on."""
    cfg, model = hymba(remat)
    opt = AdamW(AdamWConfig())
    state = TS.init_state(model, opt, 0, device="cpu")
    step = TS.make_train_step(model, opt, Constant(1e-3))
    trace.take()
    with trace.recording():
        out = step(state, tokens(cfg))
    return out + (trace.take(),)


def bitwise(a, b):
    fa, fb = dict(leaves_with_paths(a)), dict(leaves_with_paths(b))
    return sorted(fa) == sorted(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


def test_off_by_default_records_nothing_and_adds_no_node():
    cfg, model = hymba()
    opt = AdamW(AdamWConfig())
    state = TS.init_state(model, opt, 0, device="cpu")
    trace.take()
    assert not trace.RECORDER.on()
    TS.make_train_step(model, opt, Constant(1e-3))(state, tokens(cfg))
    TS.make_prefill(model)(state["params"], tokens(cfg))
    assert trace.take() == []
    t = torch.ones(3, requires_grad=True)
    assert trace.span("a", t) is trace.span("b", t) and not trace.span("a", t)
    out = trace.call("a", torch.mul, t, 2.0)
    assert type(out.grad_fn).__name__ == "MulBackward0"
    with trace.recording():
        assert trace.RECORDER.on()
        out = trace.call("a", torch.mul, t, 2.0)
    assert type(out.grad_fn).__name__ == "_EdgeBackward"
    assert not trace.RECORDER.on()
    trace.take()


@pytest.mark.parametrize("remat", ["full", "none"])
def test_tracing_leaves_losses_gradients_and_states_bitwise(remat):
    cfg, model = hymba(remat)
    params = model.init(0, device="cpu")
    batch = tokens(cfg)
    loss, metrics, grads = TS.value_and_grad(model, params, batch)
    with trace.recording():
        loss2, metrics2, grads2 = TS.value_and_grad(model, params, batch)
    assert torch.equal(loss, loss2) and bitwise(metrics, metrics2) and bitwise(grads, grads2)
    assert any(r.phase == "backward" for r in trace.take())
    opt = AdamW(AdamWConfig())
    state = TS.init_state(model, opt, 0, device="cpu")
    step = TS.make_train_step(model, opt, Constant(1e-3))
    new, m = step(state, batch)
    new2, m2, _ = train_once(remat)
    assert bitwise(new, new2) and bitwise(m, m2)


def test_tracing_leaves_prefill_logits_and_cache_bitwise():
    cfg, model = hymba("none")
    params = model.init(0, device="cpu")
    prefill = TS.make_prefill(model)
    with torch.inference_mode():
        logits, cache = prefill(params, tokens(cfg))
        trace.take()
        with trace.recording():
            logits2, cache2 = prefill(params, tokens(cfg))
    recs = trace.take()
    assert torch.equal(logits, logits2) and bitwise(cache, cache2)
    roots = [r for r in recs if r.parent is None]
    assert [(r.name, r.counters) for r in roots] == [("step.prefill", {"tokens": B * S})]
    assert sorted((r.name, r.phase) for r in recs if r.parent is not None) == sorted(
        [("model.attention", "forward"), ("model.ssd", "forward")] * cfg.num_layers)
    for r in recs:
        assert r.step == roots[0].id and r.device_ms is None  # CPU work: no device time
        assert r.launches == {"flash_attention": 0, "ssd_scan": 0}
    assert {r.counters.get("impl") for r in recs if r.name == "model.attention"} == {"dense"}
    assert {r.counters.get("route") for r in recs if r.name == "model.ssd"} == {"chunked"}


@pytest.mark.parametrize("remat", ["full", "none"])
def test_one_root_and_the_phases_of_each_layer(remat):
    _, _, recs = train_once(remat)
    cfg, _ = hymba(remat)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["step.train"]
    root = roots[0]
    assert root.counters == {"tokens": B * S}
    assert all(r.step == root.id and r.parent in (None, root.id) for r in recs)
    phases = ["forward", "recompute", "backward"] if remat == "full" else ["forward",
                                                                            "backward"]
    for name in ("model.attention", "model.ssd"):
        got = sorted(r.phase for r in recs if r.name == name)
        assert got == sorted(phases * cfg.num_layers), (name, got)
    (upd,) = [r for r in recs if r.name == "optim.update"]
    assert upd.counters["leaves"] > 0 and upd.counters["state_bytes"] > 0


@pytest.mark.parametrize("remat", ["full", "none"])
def test_spans_of_a_step_do_not_overlap_in_host_order(remat):
    _, _, recs = train_once(remat)
    (root,) = [r for r in recs if r.parent is None]
    spans = sorted((r.start_ns, r.end_ns, r.name, r.phase) for r in recs
                   if r.name in LEAVES)
    assert len(spans) > 2
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= b[0], (a, b)
    assert root.start_ns <= spans[0][0] and spans[-1][1] <= root.end_ns


def test_root_lies_inside_a_profiler_range_in_its_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    cfg, model = hymba("none")
    params = model.init(0, device="cpu")
    prefill = TS.make_prefill(model)
    trace.take()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.around"):
            prefill(params, tokens(cfg))
    (root,) = [r for r in trace.take() if r.parent is None]
    (around,) = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                 if e.name() == "test.around"]
    assert around[0] <= root.start_ns < root.end_ns <= around[1]
    assert root.end_ns - root.start_ns > (around[1] - around[0]) // 2


def test_ring_is_bounded_and_counts_what_it_drops():
    rec = trace.Recorder(capacity=4)
    with rec.recording():
        for i in range(10):
            with rec.span(f"s{i}"):
                pass
    assert [r.name for r in rec.records()] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6
    assert [r.name for r in rec.take()] == ["s6", "s7", "s8", "s9"]
    assert rec.records() == [] and rec.dropped == 6


def test_nested_spans_and_notes():
    rec = trace.Recorder()
    with rec.recording():
        with rec.span("root", tokens=3):
            rec.note("inner", route="a")  # not the innermost span's name: ignored
            with rec.span("inner") as sp:
                sp.count(n=1)
                rec.note("inner", route="b")
    inner, root = rec.take()
    assert (root.parent, root.step, root.counters) == (None, root.id, {"tokens": 3})
    assert (inner.parent, inner.step, inner.counters) == (root.id, root.id,
                                                          {"n": 1, "route": "b"})
    assert root.start_ns <= inner.start_ns <= inner.end_ns <= root.end_ns


@pytest.mark.cuda
def test_device_times_on_the_card():
    """On the card: tracing leaves the step and the prefill bitwise; every
    record has a device time, the spans' sum within their root's; a
    prefill through the kernel counts its flash launches in
    ``model.attention``.  ``pytest -m cuda tests/test_torch_trace.py``."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    cfg = reduced(get_config("hymba-1.5b"))
    model = build_model(cfg, Runtime(remat="full"))
    opt = AdamW(AdamWConfig())
    state = TS.init_state(model, opt, 0, device=dev)
    batch = {k: v.to(dev) for k, v in tokens(cfg).items()}
    step = TS.make_train_step(model, opt, Constant(1e-3))
    new, m = step(state, batch)
    trace.take()
    with trace.recording():
        new2, m2 = step(state, batch)
    recs = trace.take()
    assert bitwise(new, new2) and bitwise(m, m2)
    (root,) = [r for r in recs if r.parent is None]
    assert all(r.device_ms is not None and r.device_ms >= 0 for r in recs)
    assert sum(r.device_ms for r in recs if r.name in LEAVES) <= root.device_ms
    assert {r.phase for r in recs if r.name == "model.ssd"} == {"forward", "recompute",
                                                               "backward"}
    serve = build_model(cfg, Runtime(attn_impl="pallas", remat="none"))
    with torch.inference_mode(), trace.recording():
        TS.make_prefill(serve)(state["params"], batch)
    attn = [r for r in trace.take() if r.name == "model.attention"]
    assert len(attn) == cfg.num_layers
    assert all(r.launches["flash_attention"] == 1 and r.counters["impl"] == "pallas"
               and r.device_ms > 0 for r in attn)
