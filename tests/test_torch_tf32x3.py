"""3xTF32 on the CPU: why the port's fp32 GEMM may run on the TF32 tensor
cores without changing its result.

The kernels (``csrc/mma_tf32x3.cuh``) split each fp32 operand into two TF32
values with ``cvt.rna.tf32.f32`` (round to a 10-bit mantissa, ties away from
zero) and sum three products, small terms first. Here the split is emulated
with numpy and a 4096-deep dot product, the depth of the main path's GEMM,
is held to the card's fp32 limit (rtol 1e-4, atol 1e-3) against fp64. Plain
TF32, one product, is not within it.
"""
import numpy as np

K = 4096
RTOL, ATOL = 1e-4, 1e-3


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32``: add half of the 13
    dropped bits to the magnitude, then clear them."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(x: np.ndarray):
    big = rna_tf32(x)
    return big, rna_tf32(x - big)


def dots(a: np.ndarray, b: np.ndarray, three: bool) -> np.ndarray:
    """a (R,K) @ b (K,C) as the tensor cores take it: products of TF32
    values (exact in fp32: 11 x 11 significant bits) summed in fp32, k by
    k; with ``three``, a_small*b_big + a_big*b_small + a_big*b_big."""
    ab, as_ = split(a)
    bb, bs = split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        if three:
            acc += np.outer(as_[:, k], bb[k])
            acc += np.outer(ab[:, k], bs[k])
        acc += np.outer(ab[:, k], bb[k])
    return acc


def _inputs(seed=0, rows=48, cols=48):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, K)).astype(np.float32),
            rng.normal(size=(K, cols)).astype(np.float32))


def _outside(got, a, b):
    exact = a.astype(np.float64) @ b.astype(np.float64)
    return int((np.abs(got - exact) > ATOL + RTOL * np.abs(exact)).sum())


def test_rna_rounds_to_a_10_bit_mantissa_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                  1 + 3 * 2.0 ** -11], np.float32)
    assert list(rna_tf32(x)) == [one + ulp, -(one + ulp), one,
                                 one + 2 * ulp]


def test_split_keeps_22_bits():
    rng = np.random.default_rng(1)
    x = rng.normal(size=10_000).astype(np.float32)
    big, small = split(x)
    assert np.array_equal(rna_tf32(big), big)
    assert np.array_equal(rna_tf32(small), small)
    resid = np.abs(x.astype(np.float64) - big - small.astype(np.float64))
    assert (resid <= 2.0 ** -22 * np.abs(x)).all()


def test_three_products_hold_the_fp32_limit_at_depth_4096():
    a, b = _inputs()
    assert _outside(dots(a, b, three=True), a, b) == 0


def test_one_tf32_product_misses_the_fp32_limit():
    a, b = _inputs()
    n_bad = _outside(dots(a, b, three=False), a, b)
    assert n_bad > a.shape[0] * b.shape[1] // 2
