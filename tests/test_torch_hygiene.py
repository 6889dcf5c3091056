"""Package rules of the port: `repro_torch` imports neither jax nor the JAX
package `repro`, and its entry points never fall back to the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_module_imports_neither_jax_nor_repro(path):
    bad = sorted(n for n in _imported_modules(path) if _forbidden(n))
    assert not bad, f"{path} imports {bad}"


def test_mesh_rank_bodies_import_neither_jax_nor_repro():
    """The spawned ranks of the mesh tests import this helper only."""
    bad = sorted(n for n in _imported_modules(ROOT / "tests" /
                                              "_mesh_ranks.py")
                 if _forbidden(n))
    assert not bad


def test_data_mesh_rank_bodies_import_neither_jax_nor_repro():
    """The spawned ranks of the data-axis mesh tests import this helper
    (and `_mesh_ranks.py`) only."""
    bad = sorted(n for n in _imported_modules(ROOT / "tests" /
                                              "_mesh_data_ranks.py")
                 if _forbidden(n))
    assert not bad


def test_chip_smoke_imports_neither_jax_nor_repro():
    bad = sorted(n for n in _imported_modules(ROOT / "chip_smoke.py")
                 if _forbidden(n))
    assert not bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.configs, repro_torch.core\n"
        "import repro_torch.kernels.fc_gemv, repro_torch.kernels.decode_attention\n"
        "import repro_torch.kernels.paged_decode_attention\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.models.ssm\n"
        "import repro_torch.serving.kv_pages, repro_torch.serving.metrics\n"
        "import repro_torch.serving.faults\n"
        "import repro_torch.models, repro_torch.serving, repro_torch.launch.serve\n"
        "import repro_torch.data, repro_torch.training, repro_torch.launch.train\n"
        "import repro_torch.distributed.sharding, repro_torch.launch.mesh\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_engine_without_device_raises_on_a_cpu_only_host(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import PapiEngine
    cfg = get_config("qwen2-0.5b-smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PapiEngine(cfg, params)
    PapiEngine(cfg, params, device="cpu")        # explicit CPU is fine


def test_kernel_wrappers_do_not_build_at_import():
    from repro_torch.kernels import _build
    assert set(_build._LIBS) <= set(_build.KERNELS)
    assert not (set(_build._LIBS) and not torch.cuda.is_available())
