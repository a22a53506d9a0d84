"""The port stands alone: importing ``repro_torch`` pulls in neither JAX
nor anything of the reference package ``repro``, and no source of the
port (or ``chip_smoke.py``) names them in an import."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax\b", re.M),
    re.compile(r"^\s*import\s+repro(\.|\s|$|,)", re.M),
    re.compile(r"^\s*from\s+repro(\.|\s)", re.M),
    re.compile(r"\b__import__\(\s*['\"](jax|repro)(['\"]|\.)"),
    re.compile(r"import_module\(\s*['\"](jax|repro)(['\"]|\.)"),
]


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.score_reduce\n"
        "import repro_torch.kernels._build\n"
        "import repro_torch.core.cluster, repro_torch.core.arrivals\n"
        "import repro_torch.core.forecast, repro_torch.core.oracle\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.train.step\n"
        "import repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.cli, repro_torch.core.journal, repro_torch.core.service\n"
        "import repro_torch.models.moe\n"
        "import repro_torch.tree, repro_torch.data, repro_torch.optim\n"
        "import repro_torch.checkpoint, repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.meshes, repro_torch.distributed.fault\n"
        "import repro_torch.train.loop, repro_torch.launch.mesh\n"
        "import repro_torch.launch.train, repro_torch.launch.coschedule\n"
        "import repro_torch.roofline.analysis, repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ""


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    # the walk reaches every package of the port, the training slice's too
    for sub in ("data", "optim", "checkpoint", "distributed", "train", "launch", "roofline"):
        assert any(f.parent.name == sub for f in files), sub
    return files


def test_sources_name_no_jax_or_reference_import():
    for path in _port_sources():
        text = path.read_text()
        for pat in _FORBIDDEN:
            m = pat.search(text)
            assert m is None, f"{path.relative_to(ROOT)}: {m.group(0)!r}"


@pytest.mark.parametrize("line,bad", [
    ("import jax", True),
    ("from jax import numpy", True),
    ("import repro.core", True),
    ("from repro.core import simulate", True),
    ("from repro import core", True),
    ("import repro", True),
    ("import repro_torch.core", False),
    ("from repro_torch.core import simulate", False),
    ("import jaxlib_like_name", False),
])
def test_scan_pattern_word_boundary(line, bad):
    assert any(p.search(line) for p in _FORBIDDEN) is bad
