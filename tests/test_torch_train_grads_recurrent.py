"""Training's loss and gradients of the recurrent families, the port
against a live run of the JAX package on the CPU
(``tests/torch_train_parity.py``): recurrentgemma-9b (the RG-LRU's
doubling scan, the windowed attention past its window) and xlstm-1.3b
(the chunkwise mLSTM at chunks of 8 and the per-step scan, and sLSTM).
"""
import pytest

from torch_train_parity import family_grads_match_jax


@pytest.mark.parametrize("name,pkw", [
    ("recurrentgemma-9b", {}), ("xlstm-1.3b", {"mlstm_chunk": 8}),
    ("xlstm-1.3b", {})],
    ids=["recurrentgemma-9b", "xlstm-1.3b-chunkwise", "xlstm-1.3b-steps"])
def test_loss_and_grads_match_jax(name, pkw):
    """Loss within 1e-5 relative, each gradient leaf within 1e-4 of its
    largest entry (+1e-7), on the reference's weights and batch."""
    family_grads_match_jax(name, pkw)
