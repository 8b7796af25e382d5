"""The four simulator properties of tests/test_planner.py on the port
(``repro_torch.core.planner.simulator``), under hypothesis, each also
holding the port's numbers equal to the JAX package's. The other cases
of that file, and the equality checks, are in tests/test_torch_planner.py,
which runs without hypothesis.

Every equality is exact (float ``==``): the port runs the reference's
arithmetic in the same order. The inequalities keep the reference's own
slack (1e-9), and ``weight_bytes_per_gpu`` over TP its rtol 1e-6.
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, strategies as st

from repro.configs.base import get_config as jget_config
from repro.core.planner import hardware as jhw
from repro.core.planner import simulator as jsim
from repro_torch.configs.base import get_config
from repro_torch.core.planner.hardware import GPU_A
from repro_torch.core.planner.simulator import InstanceModel, ParallelStrategy

LLAMA = get_config("llama2-7b")
JLLAMA = jget_config("llama2-7b")


@given(s1=st.integers(64, 2048), s2=st.integers(64, 2048))
def test_prefill_latency_monotone_in_seq(s1, s2):
    m = InstanceModel(LLAMA, GPU_A, ParallelStrategy())
    lo, hi = min(s1, s2), max(s1, s2)
    assert m.prefill_latency(lo) <= m.prefill_latency(hi) + 1e-9
    jm = jsim.InstanceModel(JLLAMA, jhw.GPU_A, jsim.ParallelStrategy())
    assert m.prefill_latency(hi) == jm.prefill_latency(hi)


@given(b1=st.integers(1, 128), b2=st.integers(1, 128))
def test_decode_latency_monotone_in_batch(b1, b2):
    m = InstanceModel(LLAMA, GPU_A, ParallelStrategy())
    lo, hi = min(b1, b2), max(b1, b2)
    assert m.decode_latency(lo, 512) <= m.decode_latency(hi, 512) + 1e-9
    jm = jsim.InstanceModel(JLLAMA, jhw.GPU_A, jsim.ParallelStrategy())
    assert m.decode_latency(lo, 512) == jm.decode_latency(lo, 512)


@given(tp=st.sampled_from([1, 2, 4, 8]))
def test_tp_shards_weights(tp):
    m = InstanceModel(LLAMA, GPU_A, ParallelStrategy(tp=tp))
    base = InstanceModel(LLAMA, GPU_A, ParallelStrategy())
    np.testing.assert_allclose(m.weight_bytes_per_gpu(),
                               base.weight_bytes_per_gpu() / tp, rtol=1e-6)
    jm = jsim.InstanceModel(JLLAMA, jhw.GPU_A, jsim.ParallelStrategy(tp=tp))
    assert m.weight_bytes_per_gpu() == jm.weight_bytes_per_gpu()


@given(seq=st.integers(128, 4096))
def test_vram_decode_grows_with_batch(seq):
    m = InstanceModel(LLAMA, GPU_A, ParallelStrategy())
    assert m.vram_decode(1, seq) < m.vram_decode(16, seq)
    jm = jsim.InstanceModel(JLLAMA, jhw.GPU_A, jsim.ParallelStrategy())
    assert m.vram_decode(16, seq) == jm.vram_decode(16, seq)
