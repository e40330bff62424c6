"""Training on a device mesh, the families the reference shards beyond
the dense GQA configs (``test_torch_mesh.py``): deepseek-v3-671b (MLA, the
MoE with shared experts and the sigmoid router, the dense first layers),
musicgen-large (frame embeddings, cross-attention) and qwen3-moe-30b-a3b
at ``microbatches`` 2 (the rows split on a mesh, the dispatch groups
reckoned from each microbatch's tokens). Each takes two AdamW steps over
(data 2, model 2) on 4 gloo ranks against the reference's own sharded
steps on 4 forced host devices (``torch_mesh_parity.run_both``).
"""
import pytest

import torch_mesh_parity as MP
import torch_mesh_ranks as R

RUNS = [("deepseek-v3-671b", {}), ("musicgen-large", {}),
        ("qwen3-moe-30b-a3b", {"microbatches": 2})]
TAGS = [R.tag(*run) for run in RUNS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return MP.run_both(tmp_path_factory.mktemp("families"), 2, 2, RUNS)


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_losses_match_the_references(runs, tag):
    """Both steps' losses within LOSS_RTOL of the reference's on its
    4-device mesh."""
    MP.assert_losses_match(runs[tag], 4)


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_updates_match_the_references(runs, tag):
    """Each weight's update over the two steps within 1e-3 of the norm of
    the reference's."""
    MP.assert_updates_match(runs[tag])
