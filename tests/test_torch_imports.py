"""The PyTorch port imports neither JAX nor the JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "raindrop_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_the_module_list_covers_the_training_slice():
    mods = set(_port_modules())
    assert mods >= {"raindrop_tpu_torch.utils.dropout",
                    "raindrop_tpu_torch.data.sampler",
                    "raindrop_tpu_torch.train.trainer",
                    "raindrop_tpu_torch.ops.flash_attention",
                    "raindrop_tpu_torch.ops.fused_encoder",
                    "raindrop_tpu_torch.ops.segment",
                    "raindrop_tpu_torch.ops.sparse",
                    "raindrop_tpu_torch.graph.structure",
                    "raindrop_tpu_torch.graph.propagate",
                    "raindrop_tpu_torch.bridge", "raindrop_tpu_torch.config",
                    # the protocol slice
                    "raindrop_tpu_torch.train.metrics",
                    "raindrop_tpu_torch.train.plateau",
                    "raindrop_tpu_torch.train.checkpoint",
                    "raindrop_tpu_torch.utils.tracking",
                    "raindrop_tpu_torch.utils.diagnostics",
                    "raindrop_tpu_torch.data.normalize",
                    "raindrop_tpu_torch.data.datasets",
                    # the experiment CLI's slice
                    "raindrop_tpu_torch.data.settings",
                    "raindrop_tpu_torch.data.imputation",
                    "raindrop_tpu_torch.data.prefetch",
                    "raindrop_tpu_torch.run",
                    # the baselines' slice
                    "raindrop_tpu_torch.baselines",
                    "raindrop_tpu_torch.baselines.adapters",
                    "raindrop_tpu_torch.baselines.transformer",
                    "raindrop_tpu_torch.baselines.transformer_ctx",
                    "raindrop_tpu_torch.baselines.transformer_moe",
                    "raindrop_tpu_torch.baselines.seft",
                    "raindrop_tpu_torch.baselines.grud",
                    "raindrop_tpu_torch.baselines.mtand",
                    "raindrop_tpu_torch.baselines.ipnet",
                    "raindrop_tpu_torch.baselines.mtgnn",
                    "raindrop_tpu_torch.baselines.dgm2",
                    "raindrop_tpu_torch.parallel.expert",
                    "raindrop_tpu_torch.graph.transformer_conv",
                    "raindrop_tpu_torch.models.raindrop_v1",
                    # checkpoint import, raw preprocessing, the mTAND extras
                    "raindrop_tpu_torch.migrate",
                    "raindrop_tpu_torch.data.preprocess",
                    "raindrop_tpu_torch.data.collate",
                    "raindrop_tpu_torch.data.raw_irregular",
                    "raindrop_tpu_torch.data.toy",
                    "raindrop_tpu_torch.nn.losses"}


def test_the_module_list_covers_the_mesh_slice():
    assert set(_port_modules()) >= {
        "raindrop_tpu_torch.parallel", "raindrop_tpu_torch.parallel.mesh",
        "raindrop_tpu_torch.parallel.tensor", "raindrop_tpu_torch.parallel.multihost",
        "raindrop_tpu_torch.parallel.elastic", "raindrop_tpu_torch.parallel.launch",
        "raindrop_tpu_torch.parallel.expert"}


def test_the_module_list_covers_the_model_axis_routes():
    assert set(_port_modules()) >= {
        "raindrop_tpu_torch.parallel.sequence", "raindrop_tpu_torch.parallel.pipeline",
        "raindrop_tpu_torch.parallel.edge_partition"}


def test_the_module_list_covers_the_host_runtime():
    assert "raindrop_tpu_torch.native" in set(_port_modules())
    assert (PKG / "csrc" / "host" / "raindrop_host.cpp").exists()


def test_every_module_imports_with_jax_blocked():
    # pandas too: the card's machine has none (data/preprocess.py reads the
    # raw text with the csv module)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['raindrop_tpu'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import importlib\n"
        f"for m in {_port_modules() + ['chip_smoke', 'chip_ab']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'raindrop_tpu' or m.startswith('raindrop_tpu.'))\n"
        "bad = [m for m in bad if sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*")
     if p.suffix in (".py", ".cu", ".cuh", ".cpp")] + ["chip_smoke.py", "chip_ab.py"]))
def test_source_names_no_jax(path):
    text = (ROOT / path).read_text()
    assert "raindrop_tpu." not in text.replace("raindrop_tpu_torch.", "")
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert "import jax" not in text


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from raindrop_tpu_torch.config import dataset_config
    from raindrop_tpu_torch.models.raindrop import raindrop_init
    from raindrop_tpu_torch.serve import InferenceServer

    cfg = dataset_config("P19", max_len=8)
    with pytest.raises(RuntimeError):
        raindrop_init(0, cfg)
    params = raindrop_init(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(cfg, params)
    from raindrop_tpu_torch.config import TrainConfig
    from raindrop_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, TrainConfig(), params=params)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
