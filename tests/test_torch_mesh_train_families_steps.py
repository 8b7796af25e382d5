"""Training the MoE, RG-LRU and enc-dec families on a mesh of ranks — the
steps: the tiny ``moe``, ``hybrid`` (6 layers) and ``encdec`` and the
tiny DeepSeek of ``tests/test_torch_mesh_train_families.py``.
Held, at atol 1e-5, against the JAX package on an Auto-typed 1x1 mesh,
on the CPU, in float32 (``tests/torch_mesh_train_families_cases.py``
holds the configs, oracles, worlds and bodies):

  * two AdamW steps at ``OPT`` on (2, 2) and, with ZeRO-3 weights, on
    (2, 1, 2): each rank's parameters, ZeRO-1 moment slices and step
    within 1e-5 of the reference's ``make_train_artifacts`` steps' (the
    MoE at the capacity factor under which no pair drops, in both
    packages), loss, grad norm and rate within rtol 1e-5;
  * n_micro 2 for ``moe`` and ``hybrid`` on (2, 2): loss and grad norm
    within rtol 1e-5, the first moments within two bf16 steps of each
    leaf's largest element (the bf16 accumulator);
  * ``launch.train``'s rank program on (2, 1, 2) with ZeRO-3 weights, the
    batch carrying patches or frames where the model takes them: each
    rank's bytes of parameters and moments equal to ``per_chip_bytes``,
    its parameters as drawn the specs' slices of the whole draw.
"""
import pytest

from torch_mesh_train_families_cases import (  # noqa: F401 (fixtures)
    GROUPS, check_micro_batches_equal_the_reference,
    check_train_launcher_on_rank_bytes_and_draw,
    check_two_adamw_steps_equal_the_reference, jmesh, worlds)

NAMES = GROUPS[0]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,zero3", [((2, 2), False), ((2, 1, 2), True)])
def test_two_adamw_steps_equal_the_reference(worlds, jmesh, name, shape,
                                             zero3, monkeypatch):
    check_two_adamw_steps_equal_the_reference(worlds, jmesh, name, shape,
                                              zero3, monkeypatch)


@pytest.mark.parametrize("name", ["moe", "hybrid"])
def test_micro_batches_equal_the_reference(worlds, jmesh, name,
                                           monkeypatch):
    check_micro_batches_equal_the_reference(worlds, jmesh, name, monkeypatch)


@pytest.mark.parametrize("name", NAMES)
def test_train_launcher_on_rank_bytes_and_draw(worlds, name):
    check_train_launcher_on_rank_bytes_and_draw(worlds, name)
