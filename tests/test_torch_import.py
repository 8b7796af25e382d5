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
                                            "benchmarks/torch_*.py"))
                                        + list(ROOT.glob(
                                            "examples/torch_*.py"))))
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


_BAD = ("bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n")

# a spawned child of the cluster runtime: imports the worker modules and
# builds a tiny CPU engine from an EngineSpec, as a worker does
_PROBE = f"""import sys


def probe(q):
    from repro_torch.configs.base import config_from_dict
    from repro_torch.serving.engine import VendorProfile
    from repro_torch.serving.multiproc import d_worker, p_worker  # noqa
    from repro_torch.serving.multiproc.messages import EngineSpec
    spec = EngineSpec("P0", config_from_dict({TINY!r}),
                      VendorProfile("v", block_size=4), num_blocks=8,
                      role="prefill", device="cpu")
    spec.build()
    {_BAD}    q.put(bad)
"""


def test_multiproc_parent_and_spawned_worker_leave_jax_and_repro_out(
        tmp_path):
    (tmp_path / "probe_child.py").write_text(_PROBE)
    code = ("import multiprocessing as mp, sys\n"
            "import repro_torch.serving.multiproc as m\n"
            "assert {'ClusterRuntime', 'TwoProcessRuntime', 'serve_cluster',"
            " 'serve_two_process', 'ClusterSpec', 'EngineSpec', "
            "'WorkerSpec'} <= set(m.__all__)\n"
            "from repro_torch.core.transport import make_connector\n"
            "assert type(make_connector('shm')).__name__ == "
            "'SharedMemoryConnector'\n"
            "assert type(make_connector('rdma')).__name__ == "
            "'ModeledRDMAConnector'\n"
            + _BAD +
            "assert not bad, bad\n"
            "if __name__ == '__main__':\n"
            "    import probe_child\n"
            "    ctx = mp.get_context('spawn')\n"
            "    q = ctx.Queue()\n"
            "    p = ctx.Process(target=probe_child.probe, args=(q,))\n"
            "    p.start()\n"
            "    child_bad = q.get(timeout=120)\n"
            "    p.join(timeout=30)\n"
            "    assert p.exitcode == 0 and child_bad == [], child_bad\n")
    script = tmp_path / "parent.py"
    script.write_text(code)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(tmp_path)]))
    out = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr


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
    """Sliding window, MoE, MLA, the hybrid RG-LRU family, the Mamba-2 SSD
    family, the vision frontend and the encoder-decoder family are ported
    (ssm, vlm and enc-dec build their params); a "moe" family with no
    experts is not, nor MLA without its sub-config, nor a recurrent
    pattern outside the hybrid family, nor a vision frontend outside the
    vlm family, nor an encoder without the audio frontend."""
    for kw in (dict(family="ssm", attention_kind="none", num_kv_heads=0,
                    d_ff=0, ssm=dict(d_state=16, head_dim=16, expand=2,
                                     d_conv=4, chunk_size=4)),
               dict(family="vlm", frontend=dict(kind="vision",
                                                num_patches=4)),
               dict(family="audio", encoder_layers=2,
                    frontend=dict(kind="audio"))):
        params = TM.init_params(config_from_dict(dict(TINY, **kw)),
                                device="cpu")
        assert params["embed"].device.type == "cpu"
    for kw in (dict(family="moe"),
               dict(attention_kind="mla"),
               dict(family="dense", attention_kind="sliding",
                    sliding_window=8,
                    recurrent=dict(lru_width=64, d_conv=4,
                                   block_pattern=("rglru", "rglru", "attn"))),
               dict(family="audio", encoder_layers=2),
               dict(family="dense", frontend=dict(kind="vision",
                                                  num_patches=4))):
        cfg = config_from_dict(dict(TINY, **kw))
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            TM.init_params(cfg, device="cpu")
