"""The port's deployment planner (``repro_torch.core.planner``) against the
JAX package's.

1. The 14 cases of tests/test_planner.py on the port (the two-stage
   optimizer's constraints, the event simulator's qualitative results;
   the four simulator monotonicity properties under hypothesis are in
   tests/test_torch_planner_properties.py, so that these run without
   it), each also holding the port's numbers equal to the reference's.
2. Equality with ``repro``, every field: ``optimize_prefill``,
   ``optimize_decode`` and ``plan_deployment`` over every registered
   config, FIG6-FIG10 and every hardware pair of the reference's registry
   (``StageResult``, ``DeploymentPlan``; an infeasible case raises the
   same error); ``events.simulate(...).summary()`` and the other
   ``SimResult`` metrics over the families, both modes, both arrival
   kinds, encoder preambles and the port's rdma connector capabilities.
3. ``h100-sxm``: a nominal registry entry of the port only; the port's
   plan on it equals the reference's on a ``HardwareSpec`` of the same
   fields (nothing is added to the reference's registry).
4. ``DeploymentPlan.to_cluster_spec``: counts, ``_kv_tp`` divisibility,
   TP 1 for the latent family, ``num_p``/``num_d`` overrides, ``device``.
5. One spawned mirror of tests/test_multiproc.py's planner round trip:
   plan → spec → ``ClusterRuntime`` on the CPU, tokens equal to the
   reference's single-process loop.

Every equality is exact (float ``==``): the port runs the reference's
arithmetic in the same order. The inequalities of part 1 keep the
reference's own slack (1e-9).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.compat.precision import WireFormat as JWire
from repro.core.disagg import DisaggPipeline as JPipe
from repro.core.kv_transfer import TransferEngine as JTransfer
from repro.core.planner import events as jevents
from repro.core.planner import hardware as jhw
from repro.core.planner import optimizer as jopt
from repro.core.planner import simulator as jsim
from repro.core.planner import workload as jwl
from repro.core.transport.base import ConnectorCapabilities as JCaps
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import VendorProfile as JVendor
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import GlobalScheduler as JSched
from repro.serving.server import Server as JServer
from repro_torch.configs.base import config_from_dict, get_config, list_configs
from repro_torch.core.compat.precision import WireFormat
from repro_torch.core.planner import events
from repro_torch.core.planner import hardware as hw
from repro_torch.core.planner import optimizer as opt
from repro_torch.core.planner import simulator as sim
from repro_torch.core.planner import workload as twl
from repro_torch.core.planner.hardware import GPU_A, GPU_B, get
from repro_torch.core.planner.optimizer import (optimize_decode,
                                                optimize_prefill,
                                                plan_deployment)
from repro_torch.core.planner.simulator import InstanceModel, ParallelStrategy
from repro_torch.core.planner.workload import FIG8, Workload
from repro_torch.core.transport import make_connector
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import VendorProfile
from repro_torch.serving.multiproc import serve_cluster
from repro_torch.serving.request import Request
from tests.conftest import TINY_FAMILIES

LLAMA = get_config("llama2-7b")
JLLAMA = jget_config("llama2-7b")
REF_HW = ("gpu-a", "gpu-b", "tpu-v5e", "tpu-v5p")


def _jwl(wl):
    """The reference's Workload with the port's fields."""
    return jwl.Workload(**dataclasses.asdict(wl))


def _jhw(spec):
    return jhw.HardwareSpec(**dataclasses.asdict(spec))


def _models(mod, cfg):
    return (mod.InstanceModel(cfg, mod_hw(mod).GPU_B, mod.ParallelStrategy()),
            mod.InstanceModel(cfg, mod_hw(mod).GPU_A, mod.ParallelStrategy()))


def mod_hw(mod):
    return hw if mod is sim else jhw


# --------------------------------------------------------------------------- #
# 1. tests/test_planner.py on the port, each held to the reference
# --------------------------------------------------------------------------- #
def test_faster_hbm_decodes_faster():
    fast = InstanceModel(LLAMA, GPU_A, ParallelStrategy())   # 2 TB/s HBM
    slow = InstanceModel(LLAMA, GPU_B, ParallelStrategy())   # 1 TB/s HBM
    assert fast.decode_latency(16, 1024) < slow.decode_latency(16, 1024)


def test_more_tflops_prefills_faster():
    a = InstanceModel(LLAMA, GPU_A, ParallelStrategy())      # 312 TF
    b = InstanceModel(LLAMA, GPU_B, ParallelStrategy())      # 512 TF
    assert b.prefill_latency(1024) < a.prefill_latency(1024)


def test_stage1_respects_constraints():
    wl = Workload(qps=2.0, input_len=1024, output_len=1024,
                  slo_ttft_s=0.5, slo_tpot_s=0.05)
    res = optimize_prefill(LLAMA, GPU_B, wl)
    m = InstanceModel(LLAMA, GPU_B, res.strategy)
    assert m.prefill_latency(wl.input_len) <= wl.slo_ttft_s       # (c1)
    assert m.fits(m.vram_prefill(wl.input_len))                   # (c2)
    assert res.candidates_evaluated > 10
    assert dataclasses.asdict(res) == dataclasses.asdict(
        jopt.optimize_prefill(JLLAMA, jhw.GPU_B, _jwl(wl)))


def test_stage2_respects_constraints_and_covers_qps():
    wl = Workload(qps=2.0, input_len=1024, output_len=1024,
                  slo_ttft_s=0.5, slo_tpot_s=0.05)
    res, y = optimize_decode(LLAMA, GPU_A, wl, required_qps=2.0)
    assert res.latency_s <= wl.slo_tpot_s                         # (c1)
    assert y * res.instance_capacity >= 2.0 * 0.999               # coverage
    jres, jy = jopt.optimize_decode(JLLAMA, jhw.GPU_A, _jwl(wl),
                                    required_qps=2.0)
    assert (dataclasses.asdict(res), y) == (dataclasses.asdict(jres), jy)


def test_infeasible_slo_raises():
    wl = Workload(qps=2.0, input_len=4096, output_len=64,
                  slo_ttft_s=1e-4)
    with pytest.raises(ValueError) as got:
        optimize_prefill(LLAMA, GPU_B, wl)
    with pytest.raises(ValueError) as want:
        jopt.optimize_prefill(JLLAMA, jhw.GPU_B, _jwl(wl))
    assert str(got.value) == str(want.value)


def test_plan_deployment_end_to_end():
    plan = plan_deployment(LLAMA, FIG8, p_hw=GPU_B, d_hw=GPU_A)
    assert plan.n_prefill >= 1 and plan.n_decode >= 1
    assert plan.qps_capacity >= FIG8.qps * 0.99
    assert plan.cost_per_hour > 0
    assert "P" in plan.ratio() and "D" in plan.ratio()
    jplan = jopt.plan_deployment(JLLAMA, jwl.FIG8, jhw.GPU_B, jhw.GPU_A)
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert plan.ratio() == jplan.ratio()


def test_tighter_slo_needs_no_fewer_instances():
    loose = Workload(qps=3.0, input_len=1024, output_len=512,
                     slo_ttft_s=2.0, slo_tpot_s=0.2)
    tight = Workload(qps=3.0, input_len=1024, output_len=512,
                     slo_ttft_s=0.2, slo_tpot_s=0.03)
    pl = plan_deployment(LLAMA, loose, GPU_B, GPU_A)
    pt = plan_deployment(LLAMA, tight, GPU_B, GPU_A)
    assert pt.n_prefill * pt.prefill.strategy.gpus \
        + pt.n_decode * pt.decode.strategy.gpus \
        >= pl.n_prefill * pl.prefill.strategy.gpus \
        + pl.n_decode * pl.decode.strategy.gpus


def test_disagg_beats_integrated_at_long_context():
    """Paper Figs. 9-10: cost-fair (same hardware pair), long context."""
    wl = Workload(qps=2.0, input_len=1024, output_len=1024)
    mP, mD = _models(sim, LLAMA)
    r_dis = events.simulate(LLAMA, wl, p_model=mP, d_model=mD,
                            n_prefill=1, n_decode=1, duration_s=60)
    r_int = events.simulate(LLAMA, wl, p_model=mP, d_model=mD,
                            n_prefill=1, n_decode=1, mode="integrated",
                            duration_s=60)
    assert r_dis.throughput_tok_s() > r_int.throughput_tok_s()
    assert r_dis.tpot_mean() < r_int.tpot_mean()


def test_pd_ratio_saturates_short_context():
    """Paper Fig. 7: 2P1D ≈ 3P1D at 256+256 QPS2."""
    wl = Workload(qps=2.0, input_len=256, output_len=256)
    mP, mD = _models(sim, LLAMA)
    tput = {}
    for n_p in (2, 3):
        r = events.simulate(LLAMA, wl, p_model=mP, d_model=mD,
                            n_prefill=n_p, n_decode=1, duration_s=60)
        tput[n_p] = r.throughput_tok_s()
    assert abs(tput[2] - tput[3]) / tput[2] < 0.05


def test_ttft_grows_with_input_flat_in_output():
    """Paper Fig. 6(a)."""
    mP, mD = _models(sim, LLAMA)
    base = events.simulate(LLAMA, Workload(2, 256, 256), p_model=mP,
                           d_model=mD, duration_s=40)
    long_in = events.simulate(LLAMA, Workload(2, 1024, 256), p_model=mP,
                              d_model=mD, duration_s=40)
    long_out = events.simulate(LLAMA, Workload(2, 256, 1024), p_model=mP,
                               d_model=mD, duration_s=40)
    assert long_in.ttft_mean() > base.ttft_mean() * 1.5
    assert abs(long_out.ttft_mean() - base.ttft_mean()) \
        < 0.3 * base.ttft_mean()


# --------------------------------------------------------------------------- #
# 2. equality with the reference, every field
# --------------------------------------------------------------------------- #
def _same_outcome(fn, jfn):
    """Both return equal dataclasses (or tuples of them), or both raise
    ValueError with the same message."""
    try:
        got = fn()
    except ValueError as e:
        with pytest.raises(ValueError) as want:
            jfn()
        assert str(e) == str(want.value)
        return None
    want = jfn()
    flat = lambda x: (tuple(flat(v) for v in x) if isinstance(x, tuple)
                      else dataclasses.asdict(x)
                      if dataclasses.is_dataclass(x) else x)
    assert flat(got) == flat(want)
    return got


def test_registry_keeps_the_reference_specs():
    for name in REF_HW:
        assert dataclasses.asdict(get(name)) == \
            dataclasses.asdict(jhw.get(name))
    assert set(hw.REGISTRY) == set(jhw.REGISTRY) | {"h100-sxm"}
    assert set(twl.PAPER_CONTEXTS) == set(jwl.PAPER_CONTEXTS)
    assert [dataclasses.asdict(w) for w in twl.FIG6 + [
        twl.FIG7, twl.FIG8, twl.FIG9, twl.FIG10]] == \
        [dataclasses.asdict(w) for w in jwl.FIG6 + [
            jwl.FIG7, jwl.FIG8, jwl.FIG9, jwl.FIG10]]
    assert Workload(1, 2, 3, encoder_len=4).label() == \
        jwl.Workload(1, 2, 3, encoder_len=4).label()


@pytest.mark.parametrize("name", list_configs())
def test_stages_and_plan_equal_reference_per_config(name):
    """Every registered config, FIG7 on the paper's pair (P on GPU B, D
    on GPU A), plus stage 2 at a required rate 10x the workload's."""
    cfg, jcfg = get_config(name), jget_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    wl = twl.FIG7
    _same_outcome(lambda: plan_deployment(cfg, wl, GPU_B, GPU_A),
                  lambda: jopt.plan_deployment(jcfg, _jwl(wl), jhw.GPU_B,
                                               jhw.GPU_A))
    _same_outcome(lambda: optimize_decode(cfg, GPU_A, wl, 20.0, max_gpus=4),
                  lambda: jopt.optimize_decode(jcfg, jhw.GPU_A, _jwl(wl),
                                               20.0, max_gpus=4))
    assert events.kv_wire_bytes_per_token(cfg) == \
        jevents.kv_wire_bytes_per_token(jcfg)
    for seq in (1, 100, 4097):
        assert sim.page_rounded_kv_bytes(cfg, seq, 16, 2) == \
            jsim.page_rounded_kv_bytes(jcfg, seq, 16, 2)
    for want in (1, 2, 3, 8):
        assert opt._kv_tp(cfg, want) == jopt._kv_tp(jcfg, want)
    assert opt._strategy_space(cfg, GPU_A, 8) == [
        ParallelStrategy(**dataclasses.asdict(s))
        for s in jopt._strategy_space(jcfg, jhw.GPU_A, 8)]


@pytest.mark.parametrize("wl", twl.FIG6 + [twl.FIG7, twl.FIG8, twl.FIG9,
                                           twl.FIG10],
                         ids=lambda w: w.label())
def test_plan_equals_reference_per_figure_workload(wl):
    _same_outcome(lambda: plan_deployment(LLAMA, wl, GPU_B, GPU_A),
                  lambda: jopt.plan_deployment(JLLAMA, _jwl(wl), jhw.GPU_B,
                                               jhw.GPU_A))


@pytest.mark.parametrize("p_name", REF_HW)
def test_plan_equals_reference_per_hardware_pair(p_name):
    """Every (P, D) pair of the reference's registry, on Qwen3-4B and on
    Phi-3-medium (which the 16 GB parts cannot hold)."""
    for name in ("qwen3-4b", "phi3-medium-14b"):
        cfg, jcfg = get_config(name), jget_config(name)
        wl = twl.Workload(qps=2.0, input_len=512, output_len=128,
                          slo_ttft_s=1.0, slo_tpot_s=0.08)
        for d_name in REF_HW:
            _same_outcome(
                lambda: plan_deployment(cfg, wl, get(p_name), get(d_name),
                                        max_gpus_per_instance=4),
                lambda: jopt.plan_deployment(jcfg, _jwl(wl),
                                             jhw.get(p_name),
                                             jhw.get(d_name),
                                             max_gpus_per_instance=4))


def test_framework_model_equals_reference():
    fw = sim.FrameworkModel(prefix_cache_hit=0.3, chunked_prefill=True,
                            prefill_chunk_tokens=256)
    jfw = jsim.FrameworkModel(**dataclasses.asdict(fw))
    for strat in (ParallelStrategy(), ParallelStrategy(tp=2, pp=2)):
        m = InstanceModel(LLAMA, GPU_B, strat, fw)
        jm = jsim.InstanceModel(JLLAMA, jhw.GPU_B,
                                jsim.ParallelStrategy(
                                    **dataclasses.asdict(strat)), jfw)
        assert m.prefill_latency(777) == jm.prefill_latency(777)
        assert m.decode_latency(13, 900) == jm.decode_latency(13, 900)
        assert m.max_decode_batch(1024) == jm.max_decode_batch(1024)
        assert m.prefill_qps_capacity(512) == jm.prefill_qps_capacity(512)
    for args in ((0.5, 0.2, 1000), (0.1, 0.9, 300), (0.0, 0.1, 10)):
        assert fw.handoff_exposed_seconds(*args) == \
            jfw.handoff_exposed_seconds(*args)
    for bad in (-0.1, 1.0):
        with pytest.raises(ValueError):
            sim.FrameworkModel(prefix_cache_hit=bad)
    _same_outcome(lambda: plan_deployment(LLAMA, twl.FIG9, GPU_B, GPU_A,
                                          fw=fw),
                  lambda: jopt.plan_deployment(JLLAMA, jwl.FIG9, jhw.GPU_B,
                                               jhw.GPU_A, fw=jfw))


def _rdma_caps():
    caps = make_connector("rdma").capabilities()
    return caps, JCaps(**dataclasses.asdict(caps))


def test_connector_operators_equal_reference():
    caps, jcaps = _rdma_caps()
    serial = dataclasses.replace(caps, link_sharing="exclusive")
    jserial = JCaps(**dataclasses.asdict(serial))
    for n in (0, 1, 4096, 3e9):
        for k in (1, 3):
            assert sim.connector_wire_time(n, caps, concurrent=k) == \
                jsim.connector_wire_time(n, jcaps, concurrent=k)
            assert sim.connector_wire_time(n, serial, concurrent=k) == \
                jsim.connector_wire_time(n, jserial, concurrent=k)
    for per_tok in (0, 100, 2e5, 1e6):
        assert sim.connector_chunk_tokens(caps, per_tok) == \
            jsim.connector_chunk_tokens(jcaps, per_tok)
    assert sim.connector_chunk_tokens(None, 100) == 512
    for n, tp in ((1e6, 1), (1e6, 8), (0, 4)):
        assert sim.allreduce_time(n, tp, GPU_A) == \
            jsim.allreduce_time(n, tp, jhw.GPU_A)
        assert sim.alltoall_time(n, tp, GPU_A) == \
            jsim.alltoall_time(n, tp, jhw.GPU_A)


SIM_CASES = [
    # (config, workload kwargs, simulate kwargs)
    ("llama2-7b", dict(qps=2.0, input_len=512, output_len=64), {}),
    ("llama2-7b", dict(qps=2.0, input_len=512, output_len=64),
     dict(mode="integrated", n_prefill=1, n_decode=2)),
    ("llama2-7b", dict(qps=3.0, input_len=256, output_len=32),
     dict(poisson=True, seed=5, n_prefill=2)),
    ("llama2-7b", dict(qps=2.0, input_len=1024, output_len=32),
     dict(connector="rdma")),
    ("mixtral-8x7b", dict(qps=1.0, input_len=512, output_len=32),
     dict(poisson=True, seed=1)),
    ("deepseek-v2-lite-16b", dict(qps=1.0, input_len=512, output_len=32),
     dict(connector="rdma")),
    ("recurrentgemma-9b", dict(qps=1.0, input_len=512, output_len=32), {}),
    ("mamba2-370m", dict(qps=2.0, input_len=512, output_len=32),
     dict(mode="integrated")),
    ("whisper-large-v3", dict(qps=1.0, input_len=64, output_len=32,
                              encoder_len=1500), {}),
    ("internvl2-2b", dict(qps=1.0, input_len=256, output_len=32,
                          encoder_len=256), dict(connector="rdma")),
]


@pytest.mark.parametrize("case", range(len(SIM_CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SIM_CASES)])
def test_event_simulation_equals_reference(case):
    name, wl_kw, kw = SIM_CASES[case]
    kw = dict(kw)
    cfg, jcfg = get_config(name), jget_config(name)
    wl, jw = Workload(**wl_kw), jwl.Workload(**wl_kw)
    if kw.pop("connector", None):
        kw["connector_caps"], jcaps = _rdma_caps()
    else:
        jcaps = None
    mP, mD = _models(sim, cfg)
    jP, jD = _models(jsim, jcfg)
    got = events.simulate(cfg, wl, p_model=mP, d_model=mD, duration_s=15,
                          **kw)
    kw["connector_caps"] = jcaps
    want = jevents.simulate(jcfg, jw, p_model=jP, d_model=jD,
                            duration_s=15, **kw)
    assert got.summary() == want.summary()
    assert got.completed() > 0
    for metric in ("goodput_req_s", "goodput_tok_s", "slo_attainment"):
        assert getattr(got, metric)(wl) == getattr(want, metric)(jw)
    assert (got.p_busy, got.d_busy, got.duration, got.total_tokens) == \
        (want.p_busy, want.d_busy, want.duration, want.total_tokens)
    assert [dataclasses.asdict(r) for r in got.requests] == \
        [dataclasses.asdict(r) for r in want.requests]


# --------------------------------------------------------------------------- #
# 3. h100-sxm: the port's nominal entry
# --------------------------------------------------------------------------- #
def test_h100_plan_equals_reference_on_the_same_fields():
    h100 = get("h100-sxm")
    assert (h100.tflops, h100.hbm_gb, h100.hbm_gbps, h100.link_gbps,
            h100.scaleout_gbps) == (989.4, 80.0, 3350.0, 450.0, 50.0)
    assert (h100.compute_discount, h100.hbm_discount, h100.net_discount,
            h100.cost_per_hour) == (0.55, 0.75, 0.80, 1.0)
    assert VendorProfile("v").hardware == "h100-sxm"
    assert "h100-sxm" not in jhw.REGISTRY
    jh100 = _jhw(h100)
    phase12 = Workload(qps=1.0, input_len=256, output_len=32,
                       slo_ttft_s=2.0, slo_tpot_s=0.1)
    plan = _same_outcome(
        lambda: plan_deployment(LLAMA, phase12, h100, h100),
        lambda: jopt.plan_deployment(JLLAMA, _jwl(phase12), jh100, jh100))
    assert plan.ratio() == "1P1D"                # what chip_smoke launches
    _same_outcome(lambda: plan_deployment(LLAMA, twl.FIG8, h100, GPU_A),
                  lambda: jopt.plan_deployment(JLLAMA, jwl.FIG8, jh100,
                                               jhw.GPU_A))
    assert "h100-sxm" not in jhw.REGISTRY        # the reference untouched


# --------------------------------------------------------------------------- #
# 4. to_cluster_spec
# --------------------------------------------------------------------------- #
JCFG = TINY_FAMILIES["dense"]
CFG = config_from_dict(dataclasses.asdict(JCFG))
P_VENDOR = dict(block_size=8, layout="nhbd", kv_dtype="float32", tp=2)
D_VENDOR = dict(block_size=4, layout="nbhd", kv_dtype="float32", tp=1)
VENDOR_P, VENDOR_D = VendorProfile("B", **P_VENDOR), VendorProfile("A",
                                                                   **D_VENDOR)
SEED, CHUNK = 0, 8
# loose SLOs so the tiny config is feasible on the modeled hardware
TINY_WL = dict(qps=0.1, input_len=32, output_len=8, slo_ttft_s=1e3,
               slo_tpot_s=1e3)


def test_to_cluster_spec_counts_vendors_and_device():
    plan = plan_deployment(CFG, Workload(**TINY_WL), GPU_B, GPU_A)
    spec = plan.to_cluster_spec(CFG, p_vendor=VENDOR_P, d_vendor=VENDOR_D,
                                params_seed=SEED, num_blocks=64,
                                max_batch=4, max_seq_len=64, device="cpu")
    assert len(spec.p) == plan.n_prefill and len(spec.d) == plan.n_decode
    assert spec.ratio() == plan.ratio()
    assert all(e.device == "cpu" and e.num_blocks == 64 and e.max_batch == 4
               and e.max_seq_len == 64 and e.params_seed == SEED
               for e in spec.p + spec.d)
    assert {e.role for e in spec.p} == {"prefill"}
    assert {e.role for e in spec.d} == {"decode"}
    assert spec.p[0].vendor is VENDOR_P and spec.d[0].vendor is VENDOR_D
    assert [e.name for e in spec.p] == ["gpu-b-p0"]
    # default vendors: KV-shard TP divides the KV heads; None is the card
    auto = plan.to_cluster_spec(CFG)
    assert CFG.num_kv_heads % auto.p[0].vendor.tp == 0
    assert CFG.num_kv_heads % auto.d[0].vendor.tp == 0
    assert auto.p[0].vendor.hardware == "gpu-b" and auto.p[0].device is None
    # --num-p/--num-d style override
    big = plan.to_cluster_spec(CFG, num_p=2, num_d=3)
    assert (len(big.p), len(big.d)) == (2, 3)
    assert [e.name for e in big.d] == ["gpu-a-d0", "gpu-a-d1", "gpu-a-d2"]
    # the same spec as the reference's, field for field, but the device
    jplan = jopt.plan_deployment(JCFG, jwl.Workload(**TINY_WL), jhw.GPU_B,
                                 jhw.GPU_A)
    jauto = jplan.to_cluster_spec(JCFG, num_p=2, num_d=3)
    for e, je in zip(big.p + big.d, jauto.p + jauto.d):
        assert (e.name, e.role, e.num_blocks, e.max_batch, e.max_seq_len,
                e.params_seed) == (je.name, je.role, je.num_blocks,
                                   je.max_batch, je.max_seq_len,
                                   je.params_seed)
        assert dataclasses.asdict(e.vendor) == dataclasses.asdict(je.vendor)


@pytest.mark.parametrize("name", ["llama2-7b", "qwen3-4b", "mixtral-8x7b",
                                  "deepseek-v2-lite-16b",
                                  "recurrentgemma-9b", "phi3-medium-14b"])
def test_kv_tp_divides_heads_and_latent_is_tp1(name):
    cfg = get_config(name)
    for want in range(1, 9):
        t = opt._kv_tp(cfg, want)
        assert 1 <= t <= want and max(cfg.num_kv_heads, 1) % t == 0
    plan = plan_deployment(cfg, twl.FIG7, GPU_B, GPU_A)
    spec = plan.to_cluster_spec(cfg)
    if cfg.prefill_capabilities().latent_kv:
        assert spec.p[0].vendor.tp == spec.d[0].vendor.tp == 1
    assert spec.p[0].vendor.tp == opt._kv_tp(cfg, plan.prefill.strategy.tp)
    assert spec.d[0].vendor.tp == opt._kv_tp(cfg, plan.decode.strategy.tp)


# --------------------------------------------------------------------------- #
# 5. plan → spec → ClusterRuntime (tests/test_multiproc.py's round trip)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    jp = JM.init_params(jax.random.key(SEED), JCFG)
    path = tmp_path_factory.mktemp("params") / "dense.pt"
    torch.save(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), path)
    return str(path)


def _requests(cls, n=3, max_new=4):
    rng = np.random.default_rng(7)
    return [cls(req_id=f"req-{i}",
                prompt=rng.integers(0, JCFG.vocab_size,
                                    int(rng.integers(14, 30))
                                    ).astype(np.int32),
                max_new_tokens=max_new)
            for i in range(n)]


def _serve_single():
    """The reference's single-process loop (its in-process connector: no
    shared-memory segment, so the reference's own /dev/shm leak checks
    running beside this file see none of ours)."""
    jp = JM.init_params(jax.random.key(SEED), JCFG)
    sched = JSched(JPipe(JTransfer(), JWire("raw", "float32")),
                   prefill_chunk=CHUNK)
    for name, vendor, role in (("P0", JVendor("B", **P_VENDOR), "prefill"),
                               ("D0", JVendor("A", **D_VENDOR), "decode")):
        sched.add_instance(JEngine(name, JCFG, jp, vendor, num_blocks=64,
                                   max_batch=4, max_seq_len=64, role=role))
    server = JServer(sched)
    reqs = _requests(JRequest)
    for r in reqs:
        server.submit(r)
    ticks = 0
    while sched.stats.finished < len(reqs) and ticks < 2000:
        sched.step()
        ticks += 1
    assert sched.stats.finished == len(reqs)
    return {r.req_id: list(r.output_tokens) for r in reqs}


def test_plan_to_cluster_spec_launches_planned_topology(params_path):
    plan = plan_deployment(CFG, Workload(**TINY_WL), GPU_B, GPU_A)
    spec = plan.to_cluster_spec(CFG, p_vendor=VENDOR_P, d_vendor=VENDOR_D,
                                params_seed=SEED, num_blocks=64,
                                max_batch=4, max_seq_len=64, device="cpu")
    spec = dataclasses.replace(
        spec, p=tuple(dataclasses.replace(e, params_path=params_path)
                      for e in spec.p),
        d=tuple(dataclasses.replace(e, params_path=params_path)
                for e in spec.d))
    reqs = _requests(Request)
    tokens, rt = serve_cluster(spec, reqs, prefill_chunk=CHUNK,
                               wire=WireFormat("raw", "float32"),
                               max_wall_s=300.0)
    # the planner's instance allocation is what actually launched
    assert len(rt.stats.p_dispatches) == plan.n_prefill
    assert len(rt.stats.d_dispatches) == plan.n_decode
    assert rt.stats.finished == len(reqs) and rt.stats.failed == 0
    assert tokens == _serve_single()
