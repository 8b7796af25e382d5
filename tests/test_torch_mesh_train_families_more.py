"""Training the MLA, sliding-window, SSM and vision families on a mesh of
ranks — the gradients: the tiny ``mla``, ``sliding``, ``ssm`` and ``vlm``
of ``tests/conftest.py``, each at 3 layers (a layer axis the data plane
of 2 leaves whole under ZeRO-3: a layer's weights gathered on a dim
inside it) and 4 (split: a layer broadcast by the rank that holds it).
Held, at atol 1e-5, against the JAX package on an Auto-typed 1x1 mesh,
on the CPU, in float32 (``tests/torch_mesh_train_families_cases.py``
holds the configs, oracles, worlds and bodies):

  * on (data, model) = (2, 1), (1, 2), (2, 2) and (pod, data, model) =
    (2, 1, 2), ZeRO-3 off and on at both depths: each rank's loss and
    each gradient leaf's rank slice equal to the reference's whole-batch
    ``value_and_grad`` (the data shards hold different counts of labels
    >= 0; the vision model's patch positions take label -1);
  * the controls (``collectives.skipping``: MLA's latent's sum, the SSD
    weights' data sum, the whole data sum; every column entry left out
    for the sliding family) miss the gradients of the leaves they touch
    by more than 100x the tolerance;
  * at window 8 over 16 positions the window bites, and ``chunked_sdpa``
    (``chunk_kv`` at the sequence length) keeps the gradients.
"""
import pytest

from torch_mesh_train_families_cases import (  # noqa: F401 (fixtures)
    CONTROLS, GROUPS, MESHES, VARIANTS, check_controls_miss_the_gradients,
    check_rank_gradients_equal_the_whole_batch_gradient,
    check_the_sliding_window_bites_and_chunks, worlds)

NAMES = GROUPS[1]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name,zero3,split",
                         [v for v in VARIANTS if v[0] in NAMES])
def test_rank_gradients_equal_the_whole_batch_gradient(worlds, name, shape,
                                                       zero3, split):
    check_rank_gradients_equal_the_whole_batch_gradient(worlds, name, shape,
                                                        zero3, split)


@pytest.mark.parametrize("name,shape,skip,leaves",
                         [c for c in CONTROLS if c[0] in NAMES])
def test_controls_miss_the_gradients(worlds, name, shape, skip, leaves):
    check_controls_miss_the_gradients(worlds, name, shape, skip, leaves)


def test_the_sliding_window_bites_and_chunks(worlds):
    check_the_sliding_window_bites_and_chunks(worlds)
