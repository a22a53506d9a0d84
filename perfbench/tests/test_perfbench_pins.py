"""The cells that were there before the family hooks read as they did:
for a seed, the same weights bit for bit, the same reference arithmetic
(the prefill's logits and cache entries, the training steps' losses,
gradient norms and changes, bit for bit), and the same FLOP counts at the
cells' own sizes.  The pinned digests and counts are those the benchmark
gave before the hooks existed, on one CPU thread."""
import hashlib
import json

import pytest

torch = pytest.importorskip("torch")

from perfbench_tiny import PREFILLS, TRAIN, tiny_config  # noqa: E402

import flops  # noqa: E402
import harness  # noqa: E402
import tokens as T  # noqa: E402
import weights as W  # noqa: E402
from reference import train as rt  # noqa: E402
from reference.prefill import prefill as ref_prefill  # noqa: E402

CPU = torch.device("cpu")
CELLS = {"granite-8b": PREFILLS[0], "hymba-1.5b": PREFILLS[1]}
PINNED = {
    "granite-8b": {"weights": "79747d8b7a3c31db", "prefill": "510dcff16b20c3a7",
                   "train": "36250b2161fb32f2",
                   "flops": [1642699362926592, 2137515028905984]},
    "hymba-1.5b": {"weights": "9a4a058263b96985", "prefill": "b60cb05348ab4368",
                   "train": "2b2211b3a4b597be",
                   "flops": [331192524079104, 428174393679872]},
}
CELL_FLOPS = {TRAIN: 331_192_524_079_104,
              PREFILLS[0]: 2_137_515_028_905_984, PREFILLS[1]: 642_261_590_519_808}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()[:16]


def readings(name: str) -> dict:
    """What is pinned of configuration ``name`` at the tiny size."""
    cell = harness.load_cell(CELLS[name])
    out = {"weights": digest(t for _, t in W.leaves(W.draw(tiny_config(cell.config), 2**31 + 7,
                                                           CPU)))}
    cfg = tiny_config(cell.config, dtype="float32")
    caches = []
    logits = ref_prefill(cfg, W.draw(cfg, 11, CPU),
                         torch.from_numpy(T.batch(11, 0, 3, 40, cfg["vocab_size"])),
                         on_layer=lambda li, c: caches.extend(c[k] for k in sorted(c)))
    out["prefill"] = digest([logits] + caches)
    tf = harness.load_cell(TRAIN).traffic
    batches = [torch.from_numpy(T.batch(5, i, 2, 40, cfg["vocab_size"])) for i in range(2)]
    ref = rt.train(cfg, W.draw(cfg, 5, CPU), batches, dict(tf["adamw"], lr=1e-2))
    out["train"] = hashlib.sha256(json.dumps(ref, sort_keys=True).encode()).hexdigest()[:16]
    out["flops"] = [flops.train_step_flops(cell.config, 16, 2048),
                    flops.prefill_flops(cell.config, 64, 2048)]
    return out


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_cells_read_as_before(name, one_thread):
    assert readings(name) == PINNED[name]


def test_each_cells_flops_as_before():
    for w, want in CELL_FLOPS.items():
        cell = harness.load_cell(w)
        tf = cell.traffic
        count = (flops.train_step_flops if tf["kind"] == "train" else flops.prefill_flops)
        assert count(cell.config, tf["batch"], tf["seq_len"]) == want, w
