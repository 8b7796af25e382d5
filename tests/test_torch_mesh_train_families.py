"""Training the MoE, RG-LRU and enc-dec families on a mesh of ranks — the
gradients: the tiny ``moe``, ``hybrid`` and ``encdec`` of
``tests/conftest.py`` and a tiny DeepSeek (MLA + MoE, as
``tests/test_torch_families.py`` builds it), under ZeRO-3 with groups
whose layer axis the data plane of 2 splits (a layer broadcast by the
rank that holds it) and groups whose layer axis it does not (a layer's
weights gathered on a dim inside it): one depth has both for the MoE
families (a single dense first layer, then 2 MoE layers) and the enc-dec
model (2 encoder layers, 3 decoder layers); the hybrid takes 5 layers (a
round of its pattern and a round's first two) and 6 (two rounds).
Held, at atol 1e-5, against the JAX package on an Auto-typed 1x1 mesh,
on the CPU, in float32 (``tests/torch_mesh_train_families_cases.py``
holds the configs, oracles, worlds and bodies):

  * on (data, model) = (2, 1), (1, 2), (2, 2) and (pod, data, model) =
    (2, 1, 2), ZeRO-3 off and on: each rank's loss and each gradient
    leaf's rank slice equal to the reference's whole-batch
    ``value_and_grad`` (the data shards hold different counts of labels
    >= 0); the MoE at a capacity factor of its expert count, under which
    no (token, choice) pair drops, so that each data rank's capacity of
    its own shard and the whole batch's agree;
  * the MoE on a data axis at the default factor (pairs dropped), against
    the per-shard oracle: ``value_and_grad`` of (sum of the shards'
    numerators) / (sum of their counts), each shard through the
    reference's shard_map MoE on its own — what the reference computes
    on its production mesh;
  * each adjoint this slice places is shown needed: the control that
    leaves it out (``collectives.skipping``: the router's, MLA's
    latent's, the RG-LRU's xb, the cross K/V's) misses the gradients of
    the leaves it touches by more than 100x the tolerance.

The other families: ``..._more.py``; the steps: ``..._steps*.py``.
"""
import pytest

from torch_mesh_train_families_cases import (  # noqa: F401 (fixtures)
    CONTROLS, DATA_MESHES, GROUPS, MESHES, MOE, VARIANTS,
    check_controls_miss_the_gradients,
    check_moe_on_a_data_axis_equals_the_per_shard_oracle,
    check_rank_gradients_equal_the_whole_batch_gradient, jmesh, worlds)

NAMES = GROUPS[0]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name,zero3,split",
                         [v for v in VARIANTS if v[0] in NAMES])
def test_rank_gradients_equal_the_whole_batch_gradient(worlds, name, shape,
                                                       zero3, split):
    check_rank_gradients_equal_the_whole_batch_gradient(worlds, name, shape,
                                                        zero3, split)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("shape", DATA_MESHES)
def test_moe_on_a_data_axis_equals_the_per_shard_oracle(worlds, jmesh, name,
                                                        shape):
    check_moe_on_a_data_axis_equals_the_per_shard_oracle(worlds, jmesh, name,
                                                         shape)


@pytest.mark.parametrize("name,shape,skip,leaves",
                         [c for c in CONTROLS if c[0] in NAMES])
def test_controls_miss_the_gradients(worlds, name, shape, skip, leaves):
    check_controls_miss_the_gradients(worlds, name, shape, skip, leaves)
