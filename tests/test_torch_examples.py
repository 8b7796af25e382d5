"""The port's examples (``examples/torch_*.py``) against the reference's
own scripts (``examples/*.py``) on the CPU, on the same weights: the
reference's ``init_params(jax.random.key(0), cfg)`` carried across by
``repro_torch.models.convert``, and the reference's ``CFG`` / ``VENDOR_*``
set on its imported module with ``monkeypatch`` (its files stay as they
are). The launcher's ``--demo`` builds the reference's command for the
port's example.

What is held: ``serve_disagg``'s single-process run with its D failure
and join (inproc and the modeled-RDMA connector) gives identical token
dicts, requeues and P/D dispatches; the scheduler routes on each D's
measured decode-step latency (``DecodeLoop``'s EMA of
``time.perf_counter``), so both schedulers read a clock that advances 1 ms
a call, which makes the routing a function of load alone. The
quickstart's tokens are identical and its plan line equal; its wire bytes
are the reference's plus the fixed codec's 128-byte segment header (ROADMAP
§3 B2: the port ships the monolithic handoff as one ``WireChunk``).
``plan_deployment`` prints identical lines at its defaults. ``train_tiny``
at a tiny config (2 layers, 4 steps of 2 x 16 tokens) gives each step's
loss within rtol 1e-5 of the reference's ``make_train_step`` loop on the
same data and state (``tests/test_torch_train_model.py``'s loss
tolerance), and its restored next-step loss equals the same step without a
restore bit for bit. ``--parity --two-process --connector shm`` at the tiny
config exits 0 (one spawned pair of CPU workers); ``--codec pickle``
exits citing ROADMAP §3 B7."""
import argparse
import dataclasses
import importlib.util
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.models import model as JM
from repro.serving import scheduler as JS
from repro.serving.engine import VendorProfile as JVendor
from repro.training import data as JD
from repro.training import optim as JO
from repro.training import train_step as JT
from repro_torch.configs.base import config_from_dict
from repro_torch.core.transport import wirefmt
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import scheduler as TS
from repro_torch.serving.engine import VendorProfile as TVendor
from repro_torch.training.train_step import TrainState, make_train_step

from conftest import TINY_FAMILIES, tiny

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
# the P and D vendors of the demo, at a TP that divides the tiny dense
# model's 4 KV heads
P_VENDOR = dict(block_size=16, layout="nhbd", kv_dtype="float32", tp=2,
                hardware="gpu-b")
D_VENDOR = dict(block_size=8, layout="nbhd", kv_dtype="float32", tp=1,
                hardware="gpu-a")


def _load(name: str, module: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(module, EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _converted(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _ticking_clock(monkeypatch):
    """Both schedulers' ``time.perf_counter`` advance 1 ms a call."""
    t = [0.0]

    def perf_counter():
        t[0] += 1e-3
        return t[0]
    for mod in (JS, TS):
        fake = types.SimpleNamespace(perf_counter=perf_counter,
                                     monotonic=mod.time.monotonic)
        monkeypatch.setattr(mod, "time", fake)


def _serve_modules(monkeypatch):
    """The reference's and the port's serving example, both set to the
    tiny dense model and the demo's vendors at TP 2."""
    jcfg = TINY_FAMILIES["dense"]
    ref = _load("serve_disagg.py", "ref_serve_disagg")
    port = _load("torch_serve_disagg.py", "torch_serve_disagg")
    monkeypatch.setattr(ref, "CFG", jcfg)
    monkeypatch.setattr(ref, "VENDOR_P", JVendor("vendorB", **P_VENDOR))
    monkeypatch.setattr(ref, "VENDOR_D", JVendor("vendorA", **D_VENDOR))
    monkeypatch.setattr(port, "CFG",
                        config_from_dict(dataclasses.asdict(jcfg)))
    monkeypatch.setattr(port, "VENDOR_P", TVendor("vendorB", **P_VENDOR))
    monkeypatch.setattr(port, "VENDOR_D", TVendor("vendorA", **D_VENDOR))
    return jcfg, ref, port


def _lines(text: str, prefixes) -> list:
    return [ln for ln in text.splitlines() if ln.startswith(prefixes)]


@pytest.mark.parametrize("connector", ["inproc", "rdma"])
def test_serve_disagg_faults_match_reference(monkeypatch, capsys, connector):
    jcfg, ref, port = _serve_modules(monkeypatch)
    _ticking_clock(monkeypatch)
    args = argparse.Namespace(requests=8, max_new=8, prefill_chunk=16,
                              connector=connector, codec="fixed",
                              prefix_cache=False, device="cpu")
    capsys.readouterr()
    want = ref.run_single(args, faults=True)
    ref_out = capsys.readouterr().out
    params = _converted(JM.init_params(jax.random.key(ref.PARAMS_SEED),
                                       jcfg))
    got = port.run_single(args, faults=True, params=params)
    port_out = capsys.readouterr().out
    assert got == want
    keep = ("requeues after failure", "P dispatches", "D dispatches",
            "  !!", "  ++", "serving", "KV connector")
    assert _lines(port_out, keep) == _lines(ref_out, keep)
    assert got.stats.requeues >= 1
    assert got.stats.d_dispatches["D2"] >= 1
    assert len(got.requests) == 8 and all(r.done for r in got.requests)


def test_quickstart_matches_reference(capsys):
    import runpy
    ref = runpy.run_path(str(EXAMPLES / "quickstart.py"),
                         run_name="ref_quickstart")
    ref_out = capsys.readouterr().out
    port = _load("torch_quickstart.py", "torch_quickstart")
    req, pipe = port.serve_one(params=_converted(ref["params"]),
                               device="cpu")
    line = port.plan_line()
    capsys.readouterr()
    assert req.output_tokens == ref["req"].output_tokens
    j_bytes = ref["pipeline"].transfer.stats.bytes_moved
    st = pipe.transfer.stats
    # one "kv" entry of one part (K and V in one shard-major slab): a
    # 92-byte header, aligned to 128
    header = wirefmt.nominal_header_bytes(n_entries=1, parts_per_entry=1)
    assert header == 128
    assert st.bytes_moved == j_bytes + header
    assert st.payload_bytes == j_bytes
    assert _lines(ref_out, ("plan:",)) == [line]


def test_plan_deployment_prints_the_reference_lines(monkeypatch, capsys):
    ref = _load("plan_deployment.py", "ref_plan_deployment")
    port = _load("torch_plan_deployment.py", "torch_plan_deployment")
    monkeypatch.setattr(sys, "argv", ["plan_deployment.py"])
    capsys.readouterr()
    ref.main()
    want = capsys.readouterr().out
    port.main(["--device", "cpu"])
    assert capsys.readouterr().out == want


def test_train_tiny_matches_the_reference_loop(monkeypatch, tmp_path):
    jcfg = tiny("train", num_layers=2, vocab_size=256)
    port = _load("torch_train_tiny.py", "torch_train_tiny")
    monkeypatch.setattr(port, "CFG",
                        config_from_dict(dataclasses.asdict(jcfg)))
    monkeypatch.setattr(port.tempfile, "gettempdir", lambda: str(tmp_path))
    args = argparse.Namespace(steps=4, batch=2, seq=16, device="cpu")
    jstate = JT.train_state_init(jax.random.key(0), jcfg)
    tree = _converted({"params": jstate.params, "opt": jstate.opt})
    got = port.train(args, state=TrainState(params=tree["params"],
                                            opt=tree["opt"]))
    # the reference's loop on the same data and state
    opt = JO.AdamWConfig(lr=3e-4, warmup_steps=30, total_steps=args.steps)
    step = jax.jit(JT.make_train_step(jcfg, opt, n_micro=2))
    data = iter(JD.SyntheticTokens(jcfg, JD.DataConfig(
        batch_size=args.batch, seq_len=args.seq, seed=0)))
    want = []
    for _ in range(args.steps):
        jstate, m = step(jstate, next(data))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    assert got["restored_step"] == args.steps
    # the restored state's next step against the live state's
    _, m = make_train_step(port.CFG, got["opt"], n_micro=2)(
        got["state"], got["next_batch"])
    assert torch.equal(m["loss"], got["restored_loss"])
    assert (tmp_path / port.CKPT_NAME).is_dir()


def test_serve_disagg_two_process_parity_exits_zero(monkeypatch, capsys):
    _, _, port = _serve_modules(monkeypatch)
    port.main(["--parity", "--two-process", "--connector", "shm",
               "--requests", "4", "--max-new", "6", "--device", "cpu"])
    assert "PARITY OK: 4 requests token-exact" in capsys.readouterr().out


def test_serve_disagg_pickle_codec_exits_citing_b7():
    port = _load("torch_serve_disagg.py", "torch_serve_disagg")
    with pytest.raises(SystemExit) as exc:
        port.main(["--codec", "pickle", "--device", "cpu"])
    assert "B7" in str(exc.value.code)


@pytest.mark.parametrize("flags,ref_kwargs", [
    ([], {}),
    (["--connector", "rdma"], {"connector": "rdma"}),
    (["--two-process", "--connector", "shm"],
     {"two_process": True, "connector": "shm"}),
    (["--num-p", "2", "--num-d", "2", "--connector", "shm"],
     {"num_p": 2, "num_d": 2, "connector": "shm"}),
    (["--plan", "--connector", "shm", "--prefix-cache"],
     {"plan": True, "connector": "shm", "prefix_cache": True})])
def test_demo_runs_the_port_example_as_the_reference_runs_its(
        monkeypatch, flags, ref_kwargs):
    # importing the reference launcher sets XLA_FLAGS unless it is set
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import serve as JL
    from repro_torch.launch import serve as TL
    calls = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, check: calls.append((cmd, check)))
    JL.demo(**ref_kwargs)
    TL.main(["--demo", *flags, "--device", "cpu"])
    (ref_cmd, ref_check), (cmd, check) = calls
    assert check and ref_check
    assert os.path.normpath(ref_cmd[1]) == str(EXAMPLES / "serve_disagg.py")
    assert os.path.normpath(cmd[1]) == str(EXAMPLES / "torch_serve_disagg.py")
    assert cmd[0] == ref_cmd[0] == sys.executable
    assert cmd[2:] == ref_cmd[2:] + ["--device", "cpu"]
