"""Rules of the PyTorch port: no JAX, no reference package, no silent
CPU fallback: every public constructor and entry point needs a card
unless the caller passes ``device="cpu"``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
] + sorted((ROOT / "benchmarks_torch").glob("*.py"))


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
        "import repro_torch.core.faults, repro_torch.core.faults.base\n"
        "import repro_torch.core.faults.events\n"
        "import repro_torch.core.faults.programs\n"
        "import repro_torch.core.sweep, repro_torch.obs\n"
        "import repro_torch.obs.trace, repro_torch.obs.windows\n"
        "import repro_torch.kernels.midas_route.ops\n"
        "import repro_torch.kernels.midas_route.kernel\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.flash_attention.kernel\n"
        "import repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.kernels.decode_attention.kernel\n"
        "import repro_torch.kernels.ssm_scan.ops\n"
        "import repro_torch.kernels.ssm_scan.kernel\n"
        "import repro_torch.models.mamba, repro_torch.models.moe\n"
        "import repro_torch.config, repro_torch.configs\n"
        "import repro_torch.models, repro_torch.serve\n"
        "import repro_torch.launch.serve\n"
        "repro_torch.config.get_arch('smollm-360m')\n"
        "repro_torch.config.get_arch('falcon-mamba-7b')\n"
        "repro_torch.config.get_arch('qwen3-moe-235b-a22b')\n"
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


def test_fault_modules_are_port_sources():
    """The fault layer's modules are held to the rules above: they are
    among the checked sources, and the faulted engine needs a card."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("__init__", "base", "events", "programs"):
        assert f"src/repro_torch/core/faults/{mod}.py" in names


def test_sweep_and_obs_modules_are_port_sources():
    """The sweep engine and the observability plane are held to the
    rules above: they are among the checked sources."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "src/repro_torch/core/sweep.py" in names
    for mod in ("__init__", "trace", "windows"):
        assert f"src/repro_torch/obs/{mod}.py" in names


def test_faulted_simulate_without_device_needs_a_card(monkeypatch):
    from repro_torch.core import SimConfig, make_workload, simulate
    from repro_torch.core.faults import FaultEvent

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = make_workload("bursty", T=30, m=8, N=64, device="cpu")
    cfg = SimConfig(m=8, N=64, middleware=("fleet_cache",),
                    faults=(FaultEvent("proxy_crash", t0=5, target=0),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate(cfg, wl)


def test_cuda_route_impl_on_cpu_raises():
    from repro_torch.core import SimConfig, make_workload, simulate

    wl = make_workload("bursty", T=4, m=8, N=64, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        simulate(SimConfig(m=8, N=64, route_impl="cuda"), wl,
                 do_warmup=False, device="cpu")


def _tiny_result():
    import numpy as np

    from repro_torch.core import sim

    z = np.zeros((4, 8), np.float32)
    t = np.zeros((4,), np.float32)
    return sim.SimResult(
        queue_timeline=z, arrivals=z, lat_pred=z,
        d_timeline=t.astype(np.int32), delta_l_timeline=t, pressure=t,
        steered=t, eligible=t, cache_hits=t, final_cache=None,
        config=sim.SimConfig(m=8, N=64))


def _constructors():
    """(name, call without a device) of every public constructor and
    entry point that builds tensors."""
    from repro_torch import convert, models
    from repro_torch.config import RunConfig, get_smoke_arch
    from repro_torch.core import fleet, hashring, prng, sim, sweep, telemetry
    from repro_torch.core.controllers import base as controllers
    from repro_torch.core.policies import midas
    from repro_torch.core.workloads import base as workloads
    from repro_torch.launch.serve import serve

    cfg = get_smoke_arch("smollm-360m")
    ssm = get_smoke_arch("falcon-mamba-7b")
    moe = get_smoke_arch("qwen3-moe-235b-a22b")
    return [
        ("make_ring", lambda: hashring.make_ring(8, 4)),
        ("PRNGKey", lambda: prng.PRNGKey(0)),
        ("make_sketch", lambda: telemetry.make_sketch(8)),
        ("make_hist", lambda: telemetry.make_hist()),
        ("summarize", lambda: sim.summarize(_tiny_result())),
        ("run_sweep", lambda: sweep.run_sweep(sweep.SweepSpec(
            config=sim.SimConfig(m=8, N=64), do_warmup=False,
            workloads=workloads.make_workload("bursty", T=4, m=8, N=64,
                                              device="cpu")))),
        ("init_knobs", lambda: controllers.init_knobs(2.0)),
        ("init_midas", lambda: midas.init_midas(16, 4)),
        ("init_fleet", lambda: fleet.init_fleet(16, 2, 1)),
        ("staggered_phases", lambda: telemetry.staggered_phases(8, 5)),
        ("make_workload[rename_storm]",
         lambda: workloads.make_workload("rename_storm", T=4, m=8, N=64)),
        ("make_workload[trace_replay]",
         lambda: workloads.make_workload("trace_replay", T=4, m=8, N=64)),
        ("zipf_cdf", lambda: workloads.zipf_cdf(16, 1.1)),
        ("init_params", lambda: models.init_params(cfg)),
        ("init_decode_cache",
         lambda: models.init_decode_cache(cfg, 1, 4)),
        ("params_from_numpy", lambda: convert.params_from_numpy(cfg, {})),
        ("cache_from_numpy", lambda: convert.cache_from_numpy(cfg, {})),
        ("serve", lambda: serve(cfg, RunConfig(), requests=1,
                                prompt_len=2, decode_len=1)),
        ("init_params[ssm]", lambda: models.init_params(ssm)),
        ("init_decode_cache[ssm]",
         lambda: models.init_decode_cache(ssm, 1, 4)),
        ("params_from_numpy[ssm]",
         lambda: convert.params_from_numpy(ssm, {})),
        ("cache_from_numpy[ssm]",
         lambda: convert.cache_from_numpy(ssm, {})),
        ("serve[ssm]", lambda: serve(ssm, RunConfig(), requests=1,
                                     prompt_len=4, decode_len=1)),
        ("init_params[moe]", lambda: models.init_params(moe)),
        ("init_moe_state", lambda: models.init_moe_state(moe)),
        ("moe_state_from_numpy",
         lambda: convert.moe_state_from_numpy(moe, {})),
        ("serve[moe]", lambda: serve(moe, RunConfig(), requests=1,
                                     prompt_len=4, decode_len=1)),
    ]


_NAMES = [name for name, _ in _constructors()]


@pytest.mark.parametrize("name", _NAMES)
def test_constructor_without_device_needs_a_card(monkeypatch, name):
    call = dict(_constructors())[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
