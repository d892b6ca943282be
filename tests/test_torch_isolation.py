"""The port stands alone: no jax, no ``predictionio_tpu``, no quiet CPU.

``tests/conftest.py`` imports jax into every test process, so the import
check runs in a subprocess of its own.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from predictionio_tpu_torch import device as device_mod
from predictionio_tpu_torch.kernels import build
from predictionio_tpu_torch.ops import cuda_kernels

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "predictionio_tpu_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "predictionio_tpu"}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_the_source_scan_reaches_the_evaluation_slice():
    scanned = {p.relative_to(PORT).as_posix() for p in _port_sources() if PORT in p.parents}
    assert {"utils/durability.py", "controller/metrics.py", "controller/evaluation.py",
            "controller/fast_eval.py", "parallel/sweep.py", "workflow/version_check.py",
            "workflow/loader.py", "tools/register.py", "tools/run_workflow.py",
            "tools/console.py", "tools/run_server.py", "tools/templates.py",
            "tools/import_events.py", "tools/export_events.py", "models/similarproduct.py",
            "models/ecommerce.py", "storage/batch_view.py", "obs/trace.py", "obs/flight.py",
            "obs/slo.py", "obs/top.py", "utils/resilience.py", "testing/clock.py",
            "testing/faults.py", "fleet/merge.py", "tools/health.py"} <= scanned


def test_importing_every_port_module_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import predictionio_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'predictionio_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 20
    # the evaluation slice's modules are among those imported and scanned
    assert {f"predictionio_tpu_torch.{m}" for m in (
        "utils.durability", "controller.metrics", "controller.evaluation",
        "controller.fast_eval", "parallel.sweep", "workflow.version_check",
        "workflow.loader", "tools.register", "tools.run_workflow", "tools.console",
        "tools.run_server", "tools.templates", "tools.import_events",
        "tools.export_events", "models.similarproduct", "models.ecommerce",
        "storage.batch_view", "obs.trace", "obs.flight", "obs.slo", "obs.top",
        "utils.resilience", "testing.clock", "testing.faults", "fleet.merge",
        "tools.health")} <= names


def test_no_port_source_imports_jax_or_the_jax_package():
    found = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            found += [(path.name, r) for r in roots if r in FORBIDDEN_ROOTS]
    assert not found


def test_no_port_source_turns_tf32_on():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Attribute) and target.attr == "allow_tf32":
                        assert isinstance(node.value, ast.Constant)
                        assert node.value.value is False, path
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", "") == "set_float32_matmul_precision"):
                assert node.args and node.args[0].value == "highest", path


def test_default_device_is_the_card_and_never_the_cpu():
    if torch.cuda.is_available():
        assert device_mod.resolve_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            device_mod.resolve_device()
        with pytest.raises(RuntimeError):
            device_mod.resolve_device("cuda")
        from predictionio_tpu_torch.workflow import WorkflowContext

        with pytest.raises(RuntimeError):
            WorkflowContext()
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.resolve_device("meta")


def test_cpu_tensors_never_count_a_kernel_launch():
    before = cuda_kernels.top_k_streaming.launches
    q, items = torch.randn(3, 5), torch.randn(40, 5)
    cuda_kernels.top_k_streaming(q, items, 4)
    cuda_kernels.top_k_for_users_streaming(items, items, torch.tensor([1, 2]), 4)
    assert cuda_kernels.top_k_streaming.launches == before
    before = cuda_kernels.flash_attention_fwd.launches
    qkv = torch.randn(3, 1, 2, 9, 8)
    cuda_kernels.flash_attention_fwd(*qkv, causal=True)
    assert cuda_kernels.flash_attention_fwd.launches == before


def test_build_command_targets_sm90a_from_repo_sources():
    sources = sorted((PORT / "kernels" / "csrc").glob("*.cu"))
    assert build.kernel_names() == [p.stem for p in sources] == [
        "flash_attention", "gramian_fused", "spd_solve", "topk_streaming"]
    for src in sources:
        cmd = build.build_command(src.stem, "out.so")
        text = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in text
        for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
            assert flag in cmd
        assert cmd[-1] == str(src)
        lib = pathlib.Path(build.library_path(src.stem))
        assert lib.parent == PORT / "kernels" / "_build"
        # a plain C entry returning the CUDA error code, and no PyTorch headers
        text = src.read_text()
        assert f'extern "C" int pio_{src.stem}(' in text
        assert "torch/" not in text
    assert "predictionio_tpu_torch/kernels/_build/" in (REPO / ".gitignore").read_text()


@pytest.mark.parametrize("name,replaces,constants", [
    ("topk_streaming", "pallas_kernels.py::_topk_kernel",
     {"kMaxK": cuda_kernels.TOPK_MAX_K, "kTileItems": cuda_kernels.TOPK_TILE_ITEMS,
      "kTileQueries": cuda_kernels.TOPK_TILE_QUERIES,
      "kRankChunk": cuda_kernels.TOPK_RANK_CHUNK,
      "kRunMaxKt": cuda_kernels.TOPK_RUN_MAX_KT,
      "kMaxSmem": cuda_kernels.TOPK_MAX_SMEM}),
    ("gramian_fused", "pallas_kernels.py::_gramian_kernel",
     {"kMaxR": cuda_kernels.GRAMIAN_MAX_RANK, "kKTile": cuda_kernels.GRAMIAN_K_TILE,
      "kTile": cuda_kernels.GRAMIAN_BLOCK_TILE, "kMinChunk": cuda_kernels.GRAMIAN_MIN_CHUNK,
      "kWTile": cuda_kernels.GRAMIAN_WIDE_TILE, "kWThreads": cuda_kernels.GRAMIAN_WIDE_THREADS,
      "kWMaxR": cuda_kernels.GRAMIAN_WIDE_MAX_RANK, "kRTile": cuda_kernels.GRAMIAN_ROWS_TILE,
      "kRGroup": cuda_kernels.GRAMIAN_ROWS_GROUP,
      "kRMaxThreads": cuda_kernels.GRAMIAN_ROWS_MAX_THREADS,
      "kRMaxRounds": cuda_kernels.GRAMIAN_ROWS_MAX_ROUNDS, "kRMeta": cuda_kernels.GRAMIAN_ROWS_META,
      "kMaxSmem": cuda_kernels.GRAMIAN_MAX_SMEM}),
    ("spd_solve", "pallas_kernels.py::_spd_kernel",
     {"kMaxN": cuda_kernels.SPD_MAX_N, "kWideThreads": cuda_kernels.SPD_WIDE_THREADS,
      "kWideMaxN": cuda_kernels.SPD_WIDE_MAX_N, "kBlkNb": cuda_kernels.SPD_BLOCKED_NB,
      "kBlkThreads": cuda_kernels.SPD_BLOCKED_THREADS}),
    ("flash_attention", "attention.py::_flash_kernel",
     {"kMaxD": cuda_kernels.FLASH_MAX_D, "kTile": cuda_kernels.FLASH_TILE,
      "kMaxQTiles": cuda_kernels.FLASH_MAX_Q_TILES, "kWRows": cuda_kernels.FLASH_WIDE_ROWS,
      "kWCols": cuda_kernels.FLASH_WIDE_COLS}),
])
def test_kernel_source_names_what_it_replaces_and_its_ceiling(name, replaces, constants):
    src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
    assert replaces in src
    assert "Bound at the" in src
    for const, value in constants.items():
        assert f"constexpr int {const} = {value};" in src


def test_the_native_loader_builds_only_the_ports_own_sources():
    from predictionio_tpu_torch import native

    native_dir = PORT / "native"
    assert pathlib.Path(native._HERE) == native_dir
    assert pathlib.Path(native._BUILD_DIR) == native_dir / "_build"
    listed = set()
    for name in native.LIBRARIES:
        for src in map(pathlib.Path, native.source_paths(name)):
            assert src.parent == native_dir and src.exists(), src
            listed.add(src.name)
    assert listed == {p.name for p in native_dir.glob("*.cc")}
    assert "predictionio_tpu_torch/native/_build/" in (REPO / ".gitignore").read_text()


def test_no_port_file_names_the_jax_packages_native_sources():
    files = [p for p in PORT.rglob("*") if p.is_file() and "_build" not in p.parts
             and p.suffix in (".py", ".cc", ".h", ".cu", ".cuh")]
    files.append(REPO / "chip_smoke.py")
    offenders = [str(p) for p in files if "predictionio_tpu/native" in p.read_text()]
    assert not offenders
