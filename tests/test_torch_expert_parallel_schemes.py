"""Expert parallelism on ``[1, 4]`` (both schemes, with dropped
assignments) and on the pod axis (``[2, 1, 2]``, deepseek-v3 smoke): the
gloo ranks' two clipped AdamW steps and forward against JAX on the whole
batch, as ``test_torch_expert_parallel.py`` holds ``[2, 2]``'s (whose
docstring sets out the cases)."""
import pytest

from test_torch_expert_parallel import (check_forward, check_steps,
                                        references, spawner)

MESHES = {"1x4": ((1, 4), ("mixtral-drops", "mixtral-ffn",
                           "mixtral-ffn-drops")),
          "2x1x2": ((2, 1, 2), ("deepseek-v3",))}
RUNS = [(m, c) for m, (_, cases) in MESHES.items() for c in cases]
__all__ = ["references"]   # the fixture, shared with the [2, 2] file


@pytest.fixture(scope="module")
def gloo(tmp_path_factory, references):
    return spawner(tmp_path_factory, references, MESHES)


@pytest.mark.parametrize("mesh_id,case", RUNS)
def test_ranks_equal_jax_make_train_step(gloo, references, mesh_id, case):
    shape, cases = MESHES[mesh_id]
    check_steps(gloo(mesh_id), references(case), shape, cases.index(case),
                case)


@pytest.mark.parametrize("mesh_id,case", RUNS)
def test_per_rank_forward_logits_equal_jax_forward(gloo, references, mesh_id,
                                                   case):
    shape, cases = MESHES[mesh_id]
    check_forward(gloo(mesh_id), references(case), shape,
                  cases.index(case), case)
