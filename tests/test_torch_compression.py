"""Gradient compression (``parallel/compression.py``) against the JAX
package on the CPU: the reference's ``compress_tree_psum`` run under
``jax.vmap(..., axis_name="pod")`` on a leading axis of the ranks, the
port's over a ``Reduction`` of one rank (``Reduction.local``) and of two
ranks (``torch.distributed`` over gloo, two processes). Top-k values and
residuals exactly; the plain mean within 1e-6; int8 within 0.02 of the
largest gradient entry (the two packages' random dither streams differ;
each is within one quantization step, max|g| / 127, of the exact mean).
Over the ``pod`` dim of an 8-rank mesh, the reference's own bounds of
``tests/test_sharding.py::test_grad_compression_8dev``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch
import torch.multiprocessing as mp

from repro.parallel.compression import \
    compress_tree_psum as jax_compress_tree_psum

from repro_torch.parallel.compression import (Reduction, compress_tree_psum,
                                              int8_allreduce, rank_generator,
                                              topk_error_feedback)

import torch_mesh_ranks as R

K_FRAC = 0.25


def _grads(ranks, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(ranks, 64, 32)).astype(np.float32),
            rng.normal(size=(ranks, 64, 32)).astype(np.float32) * 0.1)


def _reference(method, g, res):
    """The reference's reduced gradient and residual on each rank."""
    def f(gg, rr):
        red, new = jax_compress_tree_psum(
            {"w": gg}, {"w": rr} if method == "topk" else None, "pod",
            method, jax.random.PRNGKey(0), K_FRAC)
        return red["w"], new["w"] if new is not None else rr
    red, new = jax.vmap(f, axis_name="pod")(jnp.asarray(g), jnp.asarray(res))
    return np.asarray(red), np.asarray(new)


@pytest.mark.parametrize("method", ["none", "topk", "int8"])
def test_one_rank_matches_the_reference(method):
    g, res = _grads(1)
    want, want_res = _reference(method, g, res)
    got, got_res = compress_tree_psum(
        {"w": torch.from_numpy(g[0])}, {"w": torch.from_numpy(res[0])},
        Reduction.local(), method, seed=0, k_frac=K_FRAC)
    got, got_res = got["w"].numpy(), got_res["w"].numpy()
    if method == "topk":
        np.testing.assert_array_equal(got, want[0])
        np.testing.assert_array_equal(got_res, want_res[0])
        assert 0 < np.count_nonzero(got) < got.size
    elif method == "none":
        assert np.abs(got - want[0]).max() <= 1e-6
    else:
        scale = np.abs(g).max()
        assert np.abs(got - want[0]).max() <= 0.02 * scale
        assert np.abs(got - g[0]).max() <= scale / 127 * (1 + 1e-5)


def test_a_tree_and_the_leaf_functions():
    """A nested tree (dict, list) leaf by leaf; the int8 stream seeded by
    (seed, rank) differs between ranks and repeats for one; top-k needs
    its residuals."""
    rng = np.random.default_rng(5)
    tree = {"a": torch.from_numpy(rng.normal(size=(16, 8)).astype(
        np.float32)), "b": [torch.from_numpy(rng.normal(size=(8,)).astype(
            np.float32))]}
    zeros = {"a": torch.zeros(16, 8), "b": [torch.zeros(8)]}
    red, res = compress_tree_psum(tree, zeros, Reduction.local(), "topk",
                                  k_frac=0.5)
    for got, r, g in ((red["a"], res["a"], tree["a"]),
                      (red["b"][0], res["b"][0], tree["b"][0])):
        torch.testing.assert_close(got + r, g, rtol=0, atol=0)
        want, want_r = topk_error_feedback(g, torch.zeros_like(g),
                                           Reduction.local(), 0.5)
        assert torch.equal(got, want) and torch.equal(r, want_r)
    with pytest.raises(ValueError):
        compress_tree_psum(tree, None, Reduction.local(), "topk")
    with pytest.raises(ValueError):
        compress_tree_psum(tree, None, Reduction.local(), "fp4")
    one = Reduction.local()
    other = Reduction(sum=one.sum, max=one.max, rank=1, world=1)
    draw = [torch.rand(4, generator=rank_generator(7, r, "cpu"))
            for r in (one, one, other)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    q = int8_allreduce(tree["a"], one, rank_generator(0, one, "cpu"))
    assert q.dtype == torch.float32 and q.shape == tree["a"].shape


def _two_ranks(rank, path, out):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            world_size=2, rank=rank)
    g, res = _grads(2)
    red = Reduction.group()
    got = {}
    for method in ("none", "topk", "int8"):
        r, nr = compress_tree_psum(
            {"w": torch.from_numpy(g[rank])},
            {"w": torch.from_numpy(res[rank])}, red, method, seed=0,
            k_frac=K_FRAC)
        got[method] = [r["w"].tolist(), nr["w"].tolist()]
    dist.destroy_process_group()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(got, f)


def test_two_ranks_over_gloo_match_the_reference(tmp_path):
    """Two processes, one gloo group: each rank's mean and residual as the
    reference's vmap over two ranks gives them."""
    out = str(tmp_path / "out")
    mp.start_processes(_two_ranks, args=(str(tmp_path / "pg"), out),
                       nprocs=2, start_method="spawn")
    g, res = _grads(2)
    for rank in (0, 1):
        with open(f"{out}.{rank}") as f:
            got = {k: [np.asarray(a, np.float32) for a in v]
                   for k, v in json.load(f).items()}
        for method in ("none", "topk", "int8"):
            want, want_res = _reference(method, g, res)
            r, nr = got[method]
            if method == "topk":
                np.testing.assert_array_equal(r, want[rank])
                np.testing.assert_array_equal(nr, want_res[rank])
            elif method == "none":
                assert np.abs(r - want[rank]).max() <= 1e-6
            else:
                scale = np.abs(g).max()
                assert np.abs(r - want[rank]).max() <= 0.02 * scale
                assert np.abs(r - g.mean(0)).max() <= 0.02 * scale


def test_eight_ranks_over_a_mesh_pod_dim(tmp_path):
    """``Reduction.group`` of the ``pod`` dim of an 8-rank mesh (gloo, 8
    processes), each rank's gradient its row of the reference test's
    seeded (8, 64, 32) array: rank 0's reduced gradient against the exact
    mean within the reference's bounds (``none`` 1e-6, ``int8`` 0.02,
    ``topk`` 1.0, a sparse first step)."""
    out = tmp_path / "out.pt"
    R.spawn(R.compression_over_pod, 8, tmp_path, 8, K_FRAC, str(out))
    res = torch.load(out)
    assert res["world"] == 8
    assert res["errs"]["none"] < 1e-6
    assert res["errs"]["int8"] < 0.02
    assert res["errs"]["topk"] < 1.0
