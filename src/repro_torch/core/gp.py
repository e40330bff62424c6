"""Gaussian-process surrogate on padded static shapes (paper §III-B).

Matérn covariance with a FIXED lengthscale (the paper's key choice for
discontinuous spaces: lengthscale fitting is disrupted by discontinuities,
so ν=3/2 with ℓ=2.0 — or ℓ=1.5 under contextual variance — per Table I).

Port of ``repro/core/gp.py`` in PyTorch, whole. Observations are padded to
``max_obs`` rows with a mask, as in the reference, so the arithmetic (and
with it parity) is the reference's: the same ‖a‖²+‖b‖²−2ab distance, the
same masked, identity-padded covariance, the same fp32 Cholesky and
triangular solves. ``predict`` evaluates EVERY candidate it is given (the
§III-G exhaustive pass). The reference computes this GP outside any Pallas
kernel, so torch's linear algebra is its port; it runs on the card unless
the caller asks for the CPU. As JAX's does, a covariance that is not
positive definite gives a factor of NaNs rather than raising.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)


def kernel_fn(name: str, r: torch.Tensor, ell: float) -> torch.Tensor:
    """Covariance as a function of Euclidean distance r (outputscale 1)."""
    s = r / ell
    if name == "matern12":
        return torch.exp(-s)
    if name == "matern32":
        t = SQRT3 * s
        return (1.0 + t) * torch.exp(-t)
    if name == "matern52":
        t = SQRT5 * s
        return (1.0 + t + (5.0 / 3.0) * torch.square(s)) * torch.exp(-t)
    if name == "rbf":
        return torch.exp(-0.5 * torch.square(s))
    raise ValueError(f"unknown kernel {name!r}")


def _pairwise_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N,d),(M,d) -> (N,M) Euclidean distances, numerically safe (the
    reference's formula; ``torch.cdist`` orders its arithmetic otherwise)."""
    d2 = (torch.sum(a * a, 1)[:, None] + torch.sum(b * b, 1)[None, :]
          - 2.0 * (a @ b.T))
    return torch.sqrt(torch.clamp(d2, min=0.0))


class GPState(NamedTuple):
    X: torch.Tensor        # (max_obs, d) padded observation inputs
    y: torch.Tensor        # (max_obs,)   padded observations (raw scale)
    mask: torch.Tensor     # (max_obs,)   True where real
    chol: torch.Tensor     # (max_obs, max_obs) Cholesky of masked K + noise
    alpha: torch.Tensor    # (max_obs,)   K^{-1}(y - mean)
    y_mean: torch.Tensor   # ()
    y_std: torch.Tensor    # ()
    n: torch.Tensor        # () int32 — number of real observations


def gp_fit(X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
           extra: Optional[torch.Tensor] = None, *,
           kernel: str = "matern32", ell: float = 2.0,
           noise: float = 1e-6) -> GPState:
    """Fit on padded observations. Padding rows become unit rows in K.
    ``extra`` (max_obs,) adds per-observation diagonal noise — the
    warm-start transfer discount (None: exact legacy numerics)."""
    mf = mask.to(torch.float32)
    n = torch.clamp(mf.sum(), min=1.0)
    y_mean = torch.sum(y * mf) / n
    var = torch.sum(torch.square(y - y_mean) * mf) / n
    y_std = torch.sqrt(torch.clamp(var, min=1e-12))
    yc = (y - y_mean) / y_std * mf

    r = _pairwise_dist(X, X)
    K = kernel_fn(kernel, r, ell)
    mm = mf[:, None] * mf[None, :]
    eye = torch.eye(X.shape[0], dtype=K.dtype, device=K.device)
    K = K * mm
    # padding rows/cols -> identity so the Cholesky stays PD
    K = K + eye * (noise + (1.0 - mf))
    if extra is not None:
        K = K + torch.diag(extra * mf)
    chol, info = torch.linalg.cholesky_ex(K)
    # JAX's factor of a matrix that is not positive definite: NaN on and
    # below the diagonal (its lower triangle of an all-NaN result)
    chol = torch.where(info == 0, chol,
                       torch.tril(torch.full_like(chol, math.nan)))
    alpha = torch.cholesky_solve(yc[:, None], chol, upper=False)[:, 0]
    return GPState(X=X, y=y, mask=mask, chol=chol, alpha=alpha,
                   y_mean=y_mean, y_std=y_std, n=mf.sum().to(torch.int32))


def gp_predict(state: GPState, Xc: torch.Tensor, *, kernel: str = "matern32",
               ell: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean/std over candidates Xc (M,d) — the exhaustive pass."""
    mf = state.mask.to(torch.float32)
    r = _pairwise_dist(Xc, state.X)
    Ks = kernel_fn(kernel, r, ell) * mf[None, :]          # (M, max_obs)
    mu = Ks @ state.alpha * state.y_std + state.y_mean
    v = torch.linalg.solve_triangular(state.chol, Ks.T, upper=False)
    var = 1.0 - torch.sum(torch.square(v), dim=0)
    var = torch.clamp(var, min=1e-12)
    return mu, torch.sqrt(var) * state.y_std


class GP:
    """Stateful wrapper: padded buffers + incremental add + predict.

    The padded buffers live on the host and go to ``device`` (the card
    unless the caller passes ``"cpu"``; no card raises) at each ``fit``;
    ``predict`` returns tensors on that device."""

    def __init__(self, dim: int, max_obs: int, kernel: str = "matern32",
                 ell: float = 2.0, noise: float = 1e-6,
                 device: Optional[str] = None):
        from repro_torch.kernels.tuning import resolve_device
        self.device = resolve_device(device)
        self.dim = dim
        self.max_obs = max_obs
        self.kernel = kernel
        self.ell = ell
        self.noise = noise
        self.X = np.zeros((max_obs, dim), np.float32)
        self.y = np.zeros((max_obs,), np.float32)
        self.mask = np.zeros((max_obs,), bool)
        self._extra: Optional[np.ndarray] = None   # per-obs noise (warm start)
        self.n = 0
        self.state: Optional[GPState] = None

    def add(self, x, y_val: float, extra_noise: float = 0.0):
        if self.n >= self.max_obs:
            return  # budget guard; caller controls budgets
        self.X[self.n] = np.asarray(x, np.float32)
        self.y[self.n] = float(y_val)
        self.mask[self.n] = True
        if extra_noise and self._extra is None:
            self._extra = np.zeros((self.max_obs,), np.float32)
        if self._extra is not None:    # always write: slot may be reused
            self._extra[self.n] = float(extra_noise)
        self.n += 1
        self.state = None

    # -- speculative (fantasy) observations --------------------------------
    def mark(self) -> int:
        """Checkpoint before constant-liar/fantasy adds (batch suggestion)."""
        self._mark_n = self.n
        return self.n

    def rollback(self) -> None:
        """Discard every observation added since the last ``mark``. The padded
        buffers keep the stale rows but the mask hides them from fit/predict."""
        n0 = getattr(self, "_mark_n", None)
        self._mark_n = None
        if n0 is None or n0 >= self.n:
            return
        self.mask[n0:self.n] = False
        self.n = n0
        self.state = None

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """A copy of a host buffer on the GP's device (a fitted state must
        not alias buffers that later adds write)."""
        return torch.tensor(a, device=self.device)

    def fit(self) -> GPState:
        extra = None if self._extra is None else self._to_dev(self._extra)
        self.state = gp_fit(self._to_dev(self.X), self._to_dev(self.y),
                            self._to_dev(self.mask), extra,
                            kernel=self.kernel, ell=self.ell,
                            noise=self.noise)
        return self.state

    def upload(self, Xc) -> torch.Tensor:
        """``Xc`` as the fp32 tensor on the GP's device that ``predict``
        takes: a fixed candidate panel is uploaded once and passed again."""
        return torch.as_tensor(Xc, dtype=torch.float32, device=self.device)

    def predict(self, Xc) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean/std at ``Xc`` (numpy or a tensor, (M, d)), as fp32
        tensors on the GP's device."""
        if self.state is None:
            self.fit()
        return gp_predict(self.state, self.upload(Xc), kernel=self.kernel,
                          ell=self.ell)

    def predict_chunked(self, Xc, chunk: int = 8192):
        """Posterior at arbitrary points, processed in fixed-size chunks (the
        last one zero-padded), as the reference does to compile once per
        chunk shape (candidate-pool mode, DESIGN.md §10); the padding keeps
        each chunk's arithmetic the reference's. Returns NumPy arrays."""
        Xc = np.asarray(Xc, np.float32)
        m = Xc.shape[0]
        if m == 0:
            return np.zeros(0), np.zeros(0)
        mus, sigmas = [], []
        for lo in range(0, m, chunk):
            block = Xc[lo:lo + chunk]
            pad = chunk - block.shape[0]
            if pad:
                block = np.vstack(
                    [block, np.zeros((pad, self.dim), np.float32)])
            mu, sigma = self.predict(block)
            mus.append(mu.double().cpu().numpy())
            sigmas.append(sigma.double().cpu().numpy())
        return np.concatenate(mus)[:m], np.concatenate(sigmas)[:m]
