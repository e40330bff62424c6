"""Training on a device mesh, the recurrent families: recurrentgemma-9b
(the RG-LRU on each rank's rows and channels, windowed attention over a
slice of the query heads and the one KV head) and xlstm-1.3b (the mLSTM,
per-step and chunkwise, and the sLSTM on each rank's rows and heads). Each
takes two AdamW steps over (data 2, model 2) on 4 gloo ranks against the
reference's own sharded steps on 4 forced host devices
(``torch_mesh_parity.run_both``); the same ranks hold
``sharding.block_local``, the mechanism these blocks run through, against
the unsharded call.
"""
import pytest

import torch

import torch_mesh_parity as MP
import torch_mesh_ranks as R

RUNS = [("recurrentgemma-9b", {}), ("xlstm-1.3b", {"mlstm_chunk": 0}),
        ("xlstm-1.3b", {"mlstm_chunk": 8})]
TAGS = [R.tag(*run) for run in RUNS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return MP.run_both(tmp_path_factory.mktemp("recurrent"), 2, 2, RUNS,
                       blocks=True, spread=TAGS[1:])


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_losses_match_the_references(runs, tag):
    """Both steps' losses within LOSS_RTOL of the reference's on its
    4-device mesh (S 32 passes the smoke window of 16; the chunkwise
    mLSTM runs 4 chunks of 8)."""
    MP.assert_losses_match(runs[tag], 4)


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_updates_match_the_references(runs, tag):
    """Each weight's update over the two steps within 1e-3 of the norm of
    the reference's. xlstm's sLSTM input-gate bias has a gradient at the
    rounding level (below 1e-9: a shift of every input gate cancels
    between the cell and its normalizer, bar the normalizer's 1e-6
    start), so the reference's own sharded and unsharded updates of it
    differ by about 7e-3 of its norm; there the port is held within twice
    that spread (``torch_mesh_parity.assert_updates_match``)."""
    MP.assert_updates_match(runs[tag])


@pytest.mark.parametrize("block,outs,inputs", [
    ("channels", [0, 1], [("x",), ("w", "c"), ("w", "s")]),
    ("heads", [2], [("q",), ("r",), ("u",)]),
], ids=["rows-channels", "rows-heads"])
def test_block_local_holds_the_unsharded_call(runs, block, outs, inputs):
    """``block_local`` over (data 2, model 2): a per-channel scan on each
    rank's (rows, channels) block with a weight by channels and one whole
    on every rank, and a per-head product on each rank's (rows, heads)
    block with a weight by heads and an input every head shares. The
    outputs equal the unsharded call's and are placed by their axes, and
    so does each input's gradient: a weight's (or the shared input's) is
    the sum of the ranks' shares over the mesh dims that split what it
    lacks."""
    s, u = runs["blocks"]["sharded"], runs["blocks"]["unsharded"]
    for i in outs:
        torch.testing.assert_close(s["outs"][i], u["outs"][i], rtol=1e-6,
                                   atol=1e-6)
    want = {"channels": ["(Shard(dim=0), Shard(dim=2))",
                         "(Shard(dim=0), Shard(dim=1))"],
            "heads": ["(Shard(dim=0), Shard(dim=2))"]}[block]
    assert [s["out_placements"][i] for i in outs] == want
    for path in inputs:
        torch.testing.assert_close(s["grads"][path], u["grads"][path],
                                   rtol=1e-5, atol=1e-6)
        # each gradient arrives placed as its input was
        assert s["grad_placements"][path] == (
            "(Shard(dim=0), Replicate())" if path[0] in ("x", "q", "u")
            else "(Replicate(), Replicate())")
