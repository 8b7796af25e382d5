"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
package, and its entry points refuse to run quietly on the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import device as tdev
from repro_torch.configs.base import config_from_dict
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.disagg import DisaggPipeline
from repro_torch.core.kv_transfer import TransferEngine
from repro_torch.models import model as TM
from repro_torch.serving.engine import Engine, VendorProfile
from repro_torch.serving.scheduler import GlobalScheduler

PKG = Path(repro_torch.__file__).resolve().parent
ROOT = PKG.parents[1]

TINY = dict(name="dense", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            param_dtype="float32", compute_dtype="float32")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)],
                                                        "repro_torch."))


def test_import_leaves_jax_and_repro_out():
    mods = _modules()
    assert "repro_torch.core.disagg" in mods and len(mods) > 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PKG.rglob("*.py"))
                                        + [ROOT / "chip_smoke.py"]
                                        + list(ROOT.glob(
                                            "benchmarks/torch_*.py"))))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_entry_points_need_a_card_or_an_explicit_cpu():
    cfg = config_from_dict(TINY)
    params = TM.init_params(cfg, seed=0, device="cpu")
    vendor = VendorProfile("v", block_size=4, layout="nbhd")
    pipe = DisaggPipeline(TransferEngine(), WireFormat("raw", "float32"))
    if torch.cuda.is_available():
        assert tdev.resolve(None).type == "cuda"
        with pytest.raises(ValueError):       # CPU params, card engine
            Engine("e", cfg, params, vendor, num_blocks=8)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine("e", cfg, params, vendor, num_blocks=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GlobalScheduler(pipe)
    eng = Engine("e", cfg, params, vendor, num_blocks=8, device="cpu")
    assert eng.device.type == "cpu"
    assert GlobalScheduler(pipe, device="cpu").device.type == "cpu"


def test_other_families_raise_not_implemented():
    for kw in (dict(attention_kind="sliding", sliding_window=8),
               dict(family="moe"), dict(attention_kind="mla")):
        cfg = config_from_dict(dict(TINY, **kw))
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            TM.init_params(cfg, device="cpu")
