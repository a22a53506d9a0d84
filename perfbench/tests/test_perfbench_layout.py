"""The harness is driven by data: a cell added as files is found by its
name; the result line's keys; no card, no result; and nothing the
benchmark runs imports JAX or the JAX package."""
import ast
import json
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from perfbench_tiny import HERE, PREFILLS, ROOT, tiny_config  # noqa: E402

import harness  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _copy(tmp_path):
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path / "BENCHMARK.json"


def test_a_new_cell_is_picked_up(tmp_path):
    bench_path = _copy(tmp_path)
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "prefill_granite_8b_b2s64", "config": "granite-8b",
                               "traffic": "prefill_b2s64", "chips": 1, "why": "a test"})
    rate = next(m for m in bench["end_to_end"] if m["name"] == "prefill_tokens_per_s")
    rate["workloads"].append("prefill_granite_8b_b2s64")
    bench_path.write_text(json.dumps(bench))
    base = tmp_path / "perfbench"
    source = next(w for w in bench["workloads"] if w["name"] == PREFILLS[0])["traffic"]
    traffic = json.loads((base / "traffic" / f"{source}.json").read_text())
    (base / "traffic" / "prefill_b2s64.json").write_text(
        json.dumps(dict(traffic, batch=2, seq_len=64)))
    (base / "limits" / "prefill_granite_8b_b2s64.json").write_text(
        json.dumps({"logits_err": 0.5, "cache_err": 0.5}))
    assert traffic["batch"] > 2  # the new cell differs from the one it was copied from
    cell = harness.load_cell("prefill_granite_8b_b2s64", bench_path)
    assert (cell.traffic["batch"], cell.traffic["seq_len"]) == (2, 64)
    assert [m["name"] for m in cell.end_to_end] == ["prefill_tokens_per_s", "peak_mem_gib",
                                                    "setup_s"]
    assert "mfu.prefill" not in [m["name"] for m in cell.per_layer]  # lists its cells
    cell.config = tiny_config(cell.config)
    run = harness.run_cell(cell, seed=2**31 + 3, seconds=0.2, trace=False,
                           device=torch.device("cpu"), t_start=0.0)
    out = harness.result(cell, run, False, {"platform": "cpu"})
    assert out["correct"] and run.steps >= 1


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    cell = harness.load_cell(PREFILLS[1])
    cell.config = tiny_config(cell.config)
    cell.traffic = dict(cell.traffic, batch=2, seq_len=40, trace_steps=2)
    run = harness.run_cell(cell, seed=9, seconds=0.2, trace=trace,
                           device=torch.device("cpu"), t_start=0.0)
    out = json.loads(json.dumps(harness.result(cell, run, trace, {"platform": "cpu"})))
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert set(out["checks"]) == set(cell.limits)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if not trace:
        assert set(out["metrics"]) == {"prefill_tokens_per_s", "peak_mem_gib", "setup_s"}
    else:  # no device trace on the CPU: no per-layer number
        assert out["metrics"] == {} and "busy_s" not in out["device"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                           PREFILLS[0], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout == "" and "CUDA" in proc.stderr


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro", "repro.core", "jax.numpy", "flax"]) == [
        "flax", "jax.numpy", "repro", "repro.core"]
