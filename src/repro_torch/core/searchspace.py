"""Discrete, constrained, normalized search spaces (paper §III-D).

The paper's representation decisions, reproduced exactly:
  * mixed-type parameters (ints, floats, strings, bools) — each parameter is
    an *ordered* list of values (the user is responsible for the ordering);
  * every numerical input is normalized "in a linear fashion" onto [0, 1] by
    ordinal position, which removes the distance distortion of non-linear
    value sets (powers of two etc.) and gives categorical values an integer
    encoding (§III-D1);
  * constraints ("restrictions") filter the Cartesian product up front;
  * runtime-invalid configurations are a property of the *objective*, not the
    space — the tuner discovers them (§III-D2).

Enumeration is chunked + vectorized — each chunk of the Cartesian product is
decoded arithmetically from its mixed-radix index (``itertools.product``
order, so config indices match the reference package's) and constraints
declared as ``VectorConstraint`` are evaluated on whole value columns at
once. Plain ``Constraint`` callables still work through a chunked per-row
fallback. Config lookup runs on the sorted mixed-radix code array, and
Hamming/adjacent neighborhoods are served from a lazily built CSR index (or
computed per row, vectorized, above ``csr_build_max`` configs).

Cut from this port: the non-enumerative ``GenerativeSpace`` backend (and its
``CodeNorm`` facade and constraint-propagating sampler). A space whose
Cartesian product exceeds ``max_enumeration`` raises ``ValueError`` naming
the missing backend instead of redirecting to it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Cartesian-product ceiling. Vectorized enumeration makes 10^7+ practical
#: (benchmarks/space_bench.py); the cap only guards against runaway memory.
DEFAULT_MAX_ENUMERATION = 20_000_000

#: Rows decoded/filtered per enumeration chunk.
ENUM_CHUNK = 1 << 17

#: Spaces at most this large get a precomputed CSR neighbor index on first
#: neighbor query; larger spaces answer each query vectorized on demand.
CSR_BUILD_MAX = 1 << 18

#: Kept-config count at which X_norm switches from an eagerly materialized
#: float32 (N, d) matrix to a chunk-computed row provider (LazyNorm).
X_NORM_LAZY_MIN = 10_000_000

#: On-demand neighbor rows memoized over the visited region (partial CSR) on
#: spaces too large for the precomputed index. FIFO-evicted above this count.
NEIGHBOR_CACHE_MAX = 1 << 16




@dataclass(frozen=True)
class Param:
    name: str
    values: Tuple[Any, ...]

    def __post_init__(self):
        assert len(self.values) >= 1


Constraint = Callable[[Dict[str, Any]], bool]


class VectorConstraint:
    """A restriction evaluated on whole value columns at once.

    ``fn`` receives a dict mapping parameter name -> value array (one entry
    per candidate row of the current enumeration chunk) and returns a boolean
    array. NumPy's elementwise semantics mean most scalar restrictions — e.g.
    ``lambda c: c["MWG"] % (c["MDIMC"] * c["VWM"]) == 0`` — are already valid
    column predicates; wrapping marks them safe to broadcast. The same ``fn``
    serves scalar config dicts, so a VectorConstraint is a drop-in
    ``Constraint`` everywhere one is accepted.
    """

    __slots__ = ("fn", "name")

    def __init__(self, fn: Callable, name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "<lambda>")

    def mask(self, cols: Dict[str, np.ndarray], n_rows: int) -> np.ndarray:
        out = np.asarray(self.fn(cols))
        if out.shape != (n_rows,):
            raise ValueError(
                f"VectorConstraint {self.name!r} returned shape {out.shape}, "
                f"expected ({n_rows},) — not a column predicate")
        return out.astype(bool, copy=False)

    def __call__(self, cfg: Dict[str, Any]) -> bool:
        return bool(self.fn(cfg))



class LazyNorm:
    """Chunk-computed view of the normalized coordinate matrix.

    Above ``x_norm_lazy_min`` kept configs the full float32 (N, d) matrix is
    never materialized; rows are decoded from ``value_indices`` on demand.
    Supports exactly the access patterns the tuning stack uses — integer,
    slice and fancy indexing — each returning a fresh dense array for the
    requested rows only.
    """

    __slots__ = ("_vi", "_denom", "_single", "shape")
    dtype = np.dtype(np.float32)

    def __init__(self, value_indices: np.ndarray, denom: np.ndarray,
                 single: np.ndarray):
        self._vi = value_indices
        self._denom = denom          # (d,) float32: max(n_j - 1, 1)
        self._single = single        # (d,) bool: single-valued params -> 0.5
        self.shape = value_indices.shape

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key) -> np.ndarray:
        X = self._vi[key].astype(np.float32) / self._denom
        if self._single.any():
            X[..., self._single] = 0.5
        return X


class SearchSpace:
    """Enumerated constrained space with ordinal-normalized coordinates.

    A Cartesian product above ``max_enumeration`` raises ``ValueError``: the
    reference package redirects such spaces to its ``GenerativeSpace``
    backend, which this port has not taken over yet.
    """

    #: True on the reference package's generative backend; always False
    #: here, kept so the strategies read the same attribute.
    generative = False

    def __init__(self, params: Sequence[Param],
                 constraints: Sequence[Constraint] = (),
                 name: str = "space",
                 max_enumeration: int = DEFAULT_MAX_ENUMERATION,
                 chunk_size: int = ENUM_CHUNK,
                 csr_build_max: int = CSR_BUILD_MAX,
                 x_norm_lazy_min: int = X_NORM_LAZY_MIN,
                 neighbor_cache_max: int = NEIGHBOR_CACHE_MAX):
        cart = self._init_radix(params, constraints, name,
                                csr_build_max=csr_build_max,
                                x_norm_lazy_min=x_norm_lazy_min,
                                neighbor_cache_max=neighbor_cache_max)
        if cart > max_enumeration:
            raise ValueError(
                f"{name}: cartesian product {cart} exceeds max_enumeration "
                f"{max_enumeration}; spaces that large need the GenerativeSpace "
                "backend, which repro_torch does not provide yet")
        self.cartesian_size = cart

        idx, codes = self._enumerate(chunk_size)
        self.value_indices = idx                     # (N, d) int32
        self._codes = codes                          # (N,) int64, ascending
        self.size = len(idx)
        if self.size == 0:
            raise ValueError(f"{name}: all configurations violate constraints")

        self._set_x_norm()
        self._h_csr: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._a_csr: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._row_sq: Optional[np.ndarray] = None   # lazy ||X_norm||² cache
        self._nbr_cache: Dict[Tuple[str, int], np.ndarray] = {}

    def _init_radix(self, params: Sequence[Param],
                    constraints: Sequence[Constraint], name: str, *,
                    csr_build_max: int = CSR_BUILD_MAX,
                    x_norm_lazy_min: int = X_NORM_LAZY_MIN,
                    neighbor_cache_max: int = NEIGHBOR_CACHE_MAX) -> int:
        """Backend-independent setup (params, mixed-radix strides, value
        columns, normalization constants); returns the Cartesian size."""
        self.name = name
        self.params: Tuple[Param, ...] = tuple(params)
        self.constraints = tuple(constraints)
        self.dim = len(self.params)
        self._csr_build_max = csr_build_max
        self._x_norm_lazy_min = x_norm_lazy_min
        self._nbr_cache_max = neighbor_cache_max

        nvals = np.array([len(p.values) for p in self.params], np.int64)
        cart = math.prod(int(n) for n in nvals)
        # mixed-radix strides: the LAST parameter varies fastest, which is
        # exactly itertools.product's lexicographic order — decoding ascending
        # global indices g via (g // stride_j) % n_j reproduces the historical
        # enumeration (and therefore every pinned config index) bit-for-bit.
        strides = np.ones(self.dim, np.int64)
        for j in range(self.dim - 2, -1, -1):
            strides[j] = strides[j + 1] * nvals[j + 1]
        self._nvals = nvals
        self._strides = strides
        self._value_arrays = [np.asarray(p.values) for p in self.params]
        self._norm_denom = np.array(
            [max(len(p.values) - 1, 1) for p in self.params], np.float32)
        self._norm_single = np.array(
            [len(p.values) == 1 for p in self.params], bool)
        return cart

    def _constrain(self, idx: np.ndarray, alive: np.ndarray) -> np.ndarray:
        """Filter ``alive`` (row positions into ``idx``) through the
        constraints in declaration order, short-circuiting on survivors —
        the exact per-row semantics the seed's Python loop had."""
        for c in self.constraints:
            if alive.size == 0:
                break
            sub = idx[alive]
            if isinstance(c, VectorConstraint):
                cols = {p.name: arr[sub[:, j]] for j, (p, arr) in
                        enumerate(zip(self.params, self._value_arrays))}
                alive = alive[c.mask(cols, len(alive))]
            else:  # plain callable: chunked per-row fallback
                ok = np.fromiter(
                    (c({p.name: p.values[int(sub[i, j])]
                        for j, p in enumerate(self.params)})
                     for i in range(len(alive))),
                    dtype=bool, count=len(alive))
                alive = alive[ok]
        return alive

    # -- enumeration ---------------------------------------------------------
    def _enumerate(self, chunk_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Chunked vectorized Cartesian product + constraint filtering."""
        cart, d = self.cartesian_size, self.dim
        kept_idx: List[np.ndarray] = []
        kept_codes: List[np.ndarray] = []
        for lo in range(0, cart, chunk_size):
            g = np.arange(lo, min(lo + chunk_size, cart), dtype=np.int64)
            idx = (g[:, None] // self._strides[None, :]) % self._nvals[None, :]
            alive = self._constrain(idx, np.arange(len(g)))
            if alive.size:
                kept_idx.append(idx[alive].astype(np.int32))
                kept_codes.append(g[alive])
        if not kept_idx:
            return (np.zeros((0, d), np.int32), np.zeros(0, np.int64))
        return np.vstack(kept_idx), np.concatenate(kept_codes)

    def _set_x_norm(self) -> None:
        """Ordinal normalization: value j of n -> j/(n-1)  (n==1 -> 0.5).
        Above ``x_norm_lazy_min`` kept configs rows are chunk-computed on
        demand instead of materializing the full float32 (N, d) matrix."""
        lazy = LazyNorm(self.value_indices, self._norm_denom,
                        self._norm_single)
        self.X_norm = (lazy if self.size >= self._x_norm_lazy_min
                       else lazy[:])

    @property
    def x_norm_lazy(self) -> bool:
        return isinstance(self.X_norm, LazyNorm)

    def take(self, keep: np.ndarray) -> "SearchSpace":
        """Restrict the space to a sorted subset of its config indices
        (deterministic trimming, repro_torch.core.spaces._trim). In place."""
        keep = np.asarray(keep)
        if np.any(np.diff(self._codes[keep]) <= 0):
            # checked before any mutation so a rejected call leaves the
            # space untouched
            raise ValueError("take() needs a sorted, duplicate-free subset: "
                             "code lookups binary-search an ascending array")
        self.value_indices = self.value_indices[keep]
        self._codes = self._codes[keep]
        self.size = len(self.value_indices)
        self._set_x_norm()
        self._h_csr = self._a_csr = self._row_sq = None
        self._nbr_cache = {}
        return self

    # -- config access ------------------------------------------------------
    def config(self, i: int) -> Dict[str, Any]:
        row = self.value_indices[i]
        return {p.name: p.values[row[j]] for j, p in enumerate(self.params)}

    def configs(self, ids: Sequence[int]) -> List[Dict[str, Any]]:
        return [self.config(i) for i in ids]

    def _find_code(self, code: int) -> Optional[int]:
        if code < 0 or code >= self.cartesian_size:
            # out-of-grid short-circuit: skip the binary search entirely —
            # hot in feasible-walk rejection loops
            return None
        pos = int(np.searchsorted(self._codes, code))
        if pos < self.size and self._codes[pos] == code:
            return pos
        return None

    def index_of(self, cfg: Dict[str, Any]) -> Optional[int]:
        try:
            key = tuple(p.values.index(cfg[p.name]) for p in self.params)
        except (ValueError, KeyError):
            return None
        return self._find_code(sum(k * int(s) for k, s in zip(key, self._strides)))

    def index_of_value_indices(self, row: Sequence[int]) -> Optional[int]:
        """Row of per-param value ordinals -> config index (or None if the
        combination was filtered out by the constraints)."""
        code = 0
        for v, n, s in zip(row, self._nvals, self._strides):
            v = int(v)
            if v < 0 or v >= n:
                # out-of-grid ordinal: without this check the radix fold can
                # alias a DIFFERENT valid config's code and return its index
                return None
            code += v * int(s)
        return self._find_code(code)

    # -- neighborhoods (Hamming: differ in exactly one parameter) -----------
    def _hamming_candidates(self, rows: np.ndarray, codes: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """(m,d) ordinal rows -> (m,K) candidate codes + validity, K = Σ n_j.
        Column order is (param j asc, value v asc, v != row_j) — the exact
        order the historical dict-probe loops produced."""
        cand, valid = [], []
        for j in range(self.dim):
            vs = np.arange(self._nvals[j], dtype=np.int64)
            cand.append(codes[:, None]
                        + (vs[None, :] - rows[:, j:j + 1]) * self._strides[j])
            valid.append(vs[None, :] != rows[:, j:j + 1])
        return np.concatenate(cand, axis=1), np.concatenate(valid, axis=1)

    def _adjacent_candidates(self, rows: np.ndarray, codes: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Column order (param j asc, dv in (-1, +1)), matching the old loop."""
        cand, valid = [], []
        for j in range(self.dim):
            for dv in (-1, 1):
                v = rows[:, j] + dv
                cand.append((codes + dv * self._strides[j])[:, None])
                valid.append(((v >= 0) & (v < self._nvals[j]))[:, None])
        return np.concatenate(cand, axis=1), np.concatenate(valid, axis=1)

    def _resolve_candidates(self, cand: np.ndarray, valid: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Candidate codes -> (found mask, positions), constraint-aware."""
        pos = np.searchsorted(self._codes, cand)
        pos_c = np.minimum(pos, self.size - 1)
        found = valid & (self._codes[pos_c] == cand)
        return found, pos_c

    def _build_csr(self, candidates_fn, chunk: int = 1 << 14
                   ) -> Tuple[np.ndarray, np.ndarray]:
        counts = np.zeros(self.size, np.int64)
        blocks: List[np.ndarray] = []
        rows_all = self.value_indices.astype(np.int64)
        for lo in range(0, self.size, chunk):
            hi = min(lo + chunk, self.size)
            cand, valid = candidates_fn(rows_all[lo:hi], self._codes[lo:hi])
            found, pos = self._resolve_candidates(cand, valid)
            counts[lo:hi] = found.sum(axis=1)
            blocks.append(pos[found].astype(np.int32))  # row-major: per-row
            #                                             column order kept
        indptr = np.zeros(self.size + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        indices = (np.concatenate(blocks) if blocks
                   else np.zeros(0, np.int32))
        return indptr, indices

    def _neighbors(self, i: int, candidates_fn, csr_attr: str) -> List[int]:
        csr = getattr(self, csr_attr)
        if csr is None and self.size <= self._csr_build_max:
            csr = self._build_csr(candidates_fn)
            setattr(self, csr_attr, csr)
        if csr is not None:
            indptr, indices = csr
            return indices[indptr[i]:indptr[i + 1]].tolist()
        # space too large for a precomputed index: partial CSR over the
        # visited region — local searches (SA/MLS/GA) re-query the incumbent
        # neighborhood every step, so memoized rows turn the ~90 µs vectorized
        # recompute into a dict hit. FIFO-evicted above _nbr_cache_max rows.
        key = (csr_attr, int(i))
        hit = self._nbr_cache.get(key)
        if hit is None:
            row = self.value_indices[i:i + 1].astype(np.int64)
            cand, valid = candidates_fn(row, self._codes[i:i + 1])
            found, pos = self._resolve_candidates(cand, valid)
            hit = pos[found].astype(np.int32)
            if len(self._nbr_cache) >= self._nbr_cache_max:
                self._nbr_cache.pop(next(iter(self._nbr_cache)))
            self._nbr_cache[key] = hit
        return hit.tolist()

    def hamming_neighbors(self, i: int) -> List[int]:
        return self._neighbors(i, self._hamming_candidates, "_h_csr")

    def axis_exchange(self, i: int, j: int) -> List[int]:
        """Config indices reachable from ``i`` by changing ONLY parameter
        ``j`` — the coordinate-exchange move set (pool-mode BO refinement).
        Ascending value-ordinal order, current value excluded."""
        row = self.value_indices[i]
        code = int(self._codes[i])
        out: List[int] = []
        for v in range(int(self._nvals[j])):
            if v == int(row[j]):
                continue
            pos = self._find_code(code + (v - int(row[j]))
                                  * int(self._strides[j]))
            if pos is not None:
                out.append(pos)
        return out

    def adjacent_neighbors(self, i: int) -> List[int]:
        """Differ in one parameter by one ordinal step (for local search)."""
        return self._neighbors(i, self._adjacent_candidates, "_a_csr")

    def random_index(self, rng: np.random.Generator) -> int:
        return int(rng.integers(0, self.size))

    def nearest_index(self, x_norm: np.ndarray,
                      exclude: Optional[set] = None,
                      chunk: int = 1 << 16) -> int:
        """Snap a [0,1]^d point to the nearest enumerated config (L2)."""
        x = np.asarray(x_norm)
        if x.dtype != self.X_norm.dtype:
            # don't let a float64 query upcast the whole (N, d) matrix
            x = x.astype(self.X_norm.dtype)
        if not self.x_norm_lazy:
            d2 = np.sum((self.X_norm - x[None, :]) ** 2, axis=1)
            if exclude:
                d2[list(exclude)] = np.inf   # fresh buffer: no copy needed
            return int(np.argmin(d2))
        # lazy X_norm: chunk the scan so no (N, d) buffer materializes
        best_d, best_i = np.inf, 0
        for lo in range(0, self.size, chunk):
            d2 = np.sum((self.X_norm[lo:lo + chunk] - x[None, :]) ** 2, axis=1)
            if exclude:
                local = [e - lo for e in exclude if lo <= e < lo + len(d2)]
                if local:
                    d2[local] = np.inf
            k = int(np.argmin(d2))
            if d2[k] < best_d:
                best_d, best_i = float(d2[k]), lo + k
        return best_i

    def nearest_indices(self, X: np.ndarray, chunk: int = 1 << 16) -> np.ndarray:
        """Batch nearest_index (no exclusion), chunked over the space so the
        (q, N) distance matrix never materializes. Used by candidate-pool BO's
        LHS refresh and by cross-size warm-start record mapping."""
        X = np.asarray(X, self.X_norm.dtype)
        if X.ndim == 1:
            X = X[None, :]
        q_sq = np.sum(X * X, axis=1)
        if self._row_sq is None and not self.x_norm_lazy:
            self._row_sq = np.sum(self.X_norm * self.X_norm, axis=1)
        best_d = np.full(len(X), np.inf, np.float32)
        best_i = np.zeros(len(X), np.int64)
        for lo in range(0, self.size, chunk):
            B = self.X_norm[lo:lo + chunk]
            b_sq = (np.sum(B * B, axis=1) if self._row_sq is None
                    else self._row_sq[lo:lo + chunk])
            d2 = (q_sq[:, None] + b_sq[None, :]
                  - 2.0 * (X @ B.T))                       # (q, m)
            k = np.argmin(d2, axis=1)                      # row-contiguous
            d = d2[np.arange(len(X)), k]
            better = d < best_d
            best_d[better] = d[better]
            best_i[better] = lo + k[better]
        return best_i

    @property
    def resident_bytes(self) -> int:
        """Bytes held by materialized per-config arrays (benchmark metric)."""
        total = self.value_indices.nbytes + self._codes.nbytes
        if isinstance(self.X_norm, np.ndarray):
            total += self.X_norm.nbytes
        if self._row_sq is not None:
            total += self._row_sq.nbytes
        for csr in (self._h_csr, self._a_csr):
            if csr is not None:
                total += csr[0].nbytes + csr[1].nbytes
        return total

    def describe(self) -> str:
        lines = [f"SearchSpace {self.name}: {self.size} configs "
                 f"(cartesian {self.cartesian_size}, {self.dim} params)"]
        for p in self.params:
            vals = ", ".join(str(v) for v in p.values[:8])
            more = "..." if len(p.values) > 8 else ""
            lines.append(f"  {p.name}: [{vals}{more}] ({len(p.values)})")
        return "\n".join(lines)
