"""Rules of the PyTorch port: no JAX, no reference package, no silent
CPU fallback."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_sources_import_neither_jax_nor_repro(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.convert\n"
        "import repro_torch.kernels.midas_route.ops\n"
        "import repro_torch.kernels.midas_route.kernel\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120, check=True,
    )
    assert out.stdout.strip() == ""


def test_simulate_without_device_needs_a_card(monkeypatch):
    from repro_torch.core import SimConfig, make_workload, simulate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = make_workload("bursty", T=4, m=8, N=64, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate(SimConfig(m=8, N=64), wl)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_workload("bursty", T=4, m=8, N=64)


def test_cuda_route_impl_on_cpu_raises():
    from repro_torch.core import SimConfig, make_workload, simulate

    wl = make_workload("bursty", T=4, m=8, N=64, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        simulate(SimConfig(m=8, N=64, route_impl="cuda"), wl,
                 do_warmup=False, device="cpu")
