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

Port of ``repro/core/searchspace.py``, whole: both backends, so a space's
configs, draws and fingerprint are the reference's for the same arguments.

Scale (DESIGN.md §9): enumeration is chunked + vectorized — each chunk of the
Cartesian product is decoded arithmetically from its mixed-radix index
(``itertools.product`` order, so config indices match the reference
package's) and constraints declared as
``VectorConstraint`` are evaluated on whole value columns at once. Plain
``Constraint`` callables still work through a chunked per-row fallback.
Config lookup runs on the sorted mixed-radix code array (binary search, no
per-row tuple dict), and Hamming/adjacent neighborhoods are served from a
lazily built CSR index (or computed per row, vectorized, above
``csr_build_max`` configs).

Beyond enumeration (DESIGN.md §15): a space whose Cartesian product exceeds
``max_enumeration`` is constructed as a ``GenerativeSpace`` — the same API
surface with NO materialized codes, value-index table, or X_norm. Config
identity is the mixed-radix code itself, feasible samples come from
EWMA-adaptive rejection draws (declaration-order short-circuit preserved)
that automatically hand off to a constraint-PROPAGATING backtracking sampler
when acceptance collapses, neighborhoods are feasible walks validity-checked per candidate
and memoized like the partial-CSR frontier, and nearest-point queries round
per-dimension (exact when the rounded config is feasible) with a
deterministic feasible anchor-sample fallback. Construction is O(d).
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

#: Acceptance-EWMA threshold below which GenerativeSpace routes feasible
#: draws through the constraint-propagating sampler instead of rejection.
#: The EWMA initializes optimistically at 1.0, so loosely-constrained spaces
#: never cross it and keep byte-identical rejection draw streams.
PROPAGATE_BELOW = 0.01

#: Dead-end prefix memo entries kept per generative space (FIFO-evicted,
#: same policy as the partial-CSR neighbor cache).
DEAD_PREFIX_CACHE_MAX = 1 << 16


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


class _DepProbe(dict):
    """Config mapping that records which parameter names a constraint
    actually reads — dependency discovery for constraint propagation."""

    def __init__(self, base: Dict[str, Any], seen: set):
        super().__init__(base)
        self.seen = seen

    def __getitem__(self, key):
        self.seen.add(key)
        return super().__getitem__(key)


def _jeffreys_interval(hits: int, draws: int,
                       conf: float = 0.95) -> Tuple[float, float]:
    """Jeffreys binomial interval: equal-tailed Beta(1/2+hits, 1/2+misses)
    quantiles — the standard choice for proportions near 0, where the
    normal approximation collapses. Falls back to a Wilson score interval
    when scipy is unavailable."""
    a, b = hits + 0.5, draws - hits + 0.5
    tail = (1.0 - conf) / 2.0
    try:
        from scipy.stats import beta as _beta
        return float(_beta.ppf(tail, a, b)), float(_beta.ppf(1.0 - tail, a, b))
    except Exception:
        p = hits / max(draws, 1)
        z = 1.959963984540054
        den = 1.0 + z * z / draws
        mid = (p + z * z / (2.0 * draws)) / den
        half = z * math.sqrt(p * (1.0 - p) / draws
                             + z * z / (4.0 * draws * draws)) / den
        return max(mid - half, 0.0), min(mid + half, 1.0)


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

    When the Cartesian product exceeds ``max_enumeration``,
    ``SearchSpace(...)`` transparently constructs a :class:`GenerativeSpace`
    instead of raising — the non-enumerative backend behind the same API
    (DESIGN.md §15). Explicit subclasses are never redirected.
    """

    #: True on the generative backend; consumers that need dense-position
    #: semantics (e.g. full-space acquisition) branch on this.
    generative = False

    def __new__(cls, *args, **kwargs):
        if cls is SearchSpace and (args or "params" in kwargs):
            params = kwargs.get("params", args[0] if args else ())
            max_enum = kwargs.get("max_enumeration")
            if max_enum is None and len(args) >= 4:
                max_enum = args[3]
            if max_enum is None:
                max_enum = DEFAULT_MAX_ENUMERATION
            try:
                cart = math.prod(len(p.values) for p in params)
            except (TypeError, AttributeError):
                cart = 0
            if cart > max_enum:
                # too large to enumerate: fall through to the generative
                # backend (Python then runs GenerativeSpace.__init__ with
                # the same arguments)
                return super().__new__(GenerativeSpace)
        return super().__new__(cls)

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
            raise ValueError(f"{name}: cartesian product {cart} too large to enumerate")
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


class CodeNorm:
    """Normalized-coordinate facade for the generative backend.

    There is no (N, d) matrix to index: configs are identified by their
    mixed-radix code, so ``X_norm[codes]`` decodes the requested rows on
    demand. Only the access patterns the tuning stack uses are supported —
    an integer code or an array of codes; dense slices would require
    enumeration and raise.
    """

    __slots__ = ("_space", "shape")
    dtype = np.dtype(np.float32)

    def __init__(self, space: "GenerativeSpace"):
        self._space = space
        self.shape = (space.size, space.dim)

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key) -> np.ndarray:
        if isinstance(key, slice):
            raise TypeError(
                "CodeNorm has no dense rows to slice — index by config code "
                "(the generative backend never enumerates)")
        scalar = isinstance(key, (int, np.integer))
        codes = np.atleast_1d(np.asarray(key, np.int64))
        X = self._space._norm_rows(self._space.decode(codes))
        return X[0] if scalar else X


class GenerativeSpace(SearchSpace):
    """Constraint-native backend for spaces too large to enumerate.

    Nothing per-config is materialized — no code table, no value-index
    matrix, no X_norm (DESIGN.md §15). A config's *index* is its mixed-radix
    code in the full Cartesian grid, so ``config``/``index_of`` are O(d)
    arithmetic plus a constraint check, and ``SpaceFingerprint`` identity is
    as stable as the enumerated backend's (the digest depends only on
    params/constraints/size, all deterministic at construction).

      * feasible sampling: batched uniform code draws filtered through the
        constraints in declaration order (``_constrain`` — same short-circuit
        the enumerator uses), with the batch size adapted by an acceptance-
        rate EWMA; when the EWMA sinks below ``PROPAGATE_BELOW`` (or a
        rejection budget exhausts with zero hits) draws switch to the
        constraint-propagating backtracking sampler — dimension-by-dimension
        with per-step grid pruning and dead-prefix memoization — so tight
        constraint sets stay fast instead of stalling;
      * neighborhoods: the enumerated backend's candidate generators produce
        the neighbor *codes* directly; each candidate is validity-checked
        against the constraints on the fly and the resulting rows are
        memoized FIFO like the partial-CSR frontier;
      * nearest-point queries: per-dimension ordinal rounding (exact whenever
        the rounded config is feasible) with a deterministic feasible anchor
        set — seeded independently of caller RNG — as the fallback metric.

    ``size`` equals ``cartesian_size``: the feasible count is unknown without
    enumeration, and every consumer treats indices as opaque keys.
    """

    generative = True

    #: Deterministic seed for the anchor sample backing nearest-point
    #: fallback queries — independent of caller RNGs so repeated
    #: constructions agree.
    ANCHOR_SEED = 0xA17C4
    ANCHOR_COUNT = 4096

    #: Acceptance-EWMA routing threshold (module default; per-instance
    #: override is allowed in tests/benchmarks).
    PROPAGATE_BELOW = PROPAGATE_BELOW

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
        if cart >= 2 ** 62:
            raise ValueError(
                f"{name}: cartesian product {cart} overflows int64 "
                f"mixed-radix code arithmetic")
        self.cartesian_size = cart
        self.size = cart
        self.X_norm = CodeNorm(self)
        self._accept_ewma = 1.0     # rejection-sampling acceptance estimate
        self._accept_draws = 0      # uniform draws the EWMA has folded
        self._accept_hits = 0       # feasible hits among those draws
        self._anchor_codes: Optional[np.ndarray] = None
        self._anchor_norm: Optional[np.ndarray] = None
        self._nbr_cache: Dict[Tuple[str, int], np.ndarray] = {}
        # constraint-propagation state (lazy — _prop_init)
        self._prop_deps: Optional[List[Tuple[int, ...]]] = None
        self._prop_by_step: Optional[List[List[int]]] = None
        self._dead_prefixes: Dict[Tuple[int, ...], None] = {}
        self._prop_draws = 0        # completed propagating draws

    # -- code arithmetic -----------------------------------------------------
    def decode(self, codes: np.ndarray) -> np.ndarray:
        """Mixed-radix codes -> (m, d) per-param ordinal rows."""
        codes = np.asarray(codes, np.int64)
        return (codes[:, None] // self._strides[None, :]) % self._nvals[None, :]

    def _norm_rows(self, idx: np.ndarray) -> np.ndarray:
        X = idx.astype(np.float32) / self._norm_denom
        if self._norm_single.any():
            X[..., self._norm_single] = 0.5
        return X

    def _feasible_mask(self, codes: np.ndarray) -> np.ndarray:
        codes = np.asarray(codes, np.int64)
        idx = self.decode(codes)
        alive = self._constrain(idx, np.arange(len(codes)))
        mask = np.zeros(len(codes), bool)
        mask[alive] = True
        return mask

    @property
    def value_indices(self):
        raise AttributeError(
            f"{self.name}: GenerativeSpace materializes no value-index table "
            f"— decode config codes on demand via decode()")

    @property
    def x_norm_lazy(self) -> bool:
        return True

    def take(self, keep: np.ndarray) -> "SearchSpace":
        raise NotImplementedError(
            "GenerativeSpace has no dense index table to subset; trim the "
            "parameter grids instead")

    # -- config access -------------------------------------------------------
    def config(self, i: int) -> Dict[str, Any]:
        row = self.decode(np.asarray([int(i)], np.int64))[0]
        return {p.name: p.values[int(row[j])]
                for j, p in enumerate(self.params)}

    def _find_code(self, code: int) -> Optional[int]:
        """A code IS the index — existence just means in-grid + feasible."""
        if code < 0 or code >= self.cartesian_size:
            return None
        if bool(self._feasible_mask(np.asarray([code], np.int64))[0]):
            return int(code)
        return None

    # -- feasible sampling ---------------------------------------------------
    def sample_feasible(self, rng: np.random.Generator, m: int) -> np.ndarray:
        """m feasible codes, routed between two samplers (DESIGN.md §15).

        Rejection — constraint-filtered uniform draws with EWMA-adaptive
        batch sizing — is the fast path while the acceptance estimate stays
        above ``PROPAGATE_BELOW``; loosely-constrained spaces never cross
        the threshold (the EWMA initializes at 1.0) and keep byte-identical
        draw streams. Below it, or when a rejection budget exhausts with
        zero hits, draws come from the constraint-propagating backtracking
        sampler instead of raising: per-candidate cost then depends on the
        number of parameters, not on 1/feasible-fraction. A raising call
        (truly infeasible space) restores the entry EWMA so it cannot
        poison the next call's adaptive batch size.
        """
        m = int(m)
        if m <= 0:
            return np.zeros(0, np.int64)
        if self.constraints and self._accept_ewma < self.PROPAGATE_BELOW:
            return self._sample_propagate(rng, m)
        ewma_entry = self._accept_ewma
        out: List[np.ndarray] = []
        got, attempts = 0, 0
        budget = max(64 * m, 1 << 20)
        while got < m and attempts < budget:
            rate = max(self._accept_ewma, 1e-3)
            batch = int(min(max(int((m - got) / rate) + 16, 256), 1 << 17))
            codes = rng.integers(0, self.cartesian_size, size=batch,
                                 dtype=np.int64)
            kept = codes[self._feasible_mask(codes)]
            self._accept_ewma = (0.7 * self._accept_ewma
                                 + 0.3 * (len(kept) / batch))
            self._accept_draws += batch
            self._accept_hits += int(kept.size)
            attempts += batch
            if kept.size:
                out.append(kept)
                got += len(kept)
            elif attempts >= (1 << 17) and self.constraints \
                    and self.PROPAGATE_BELOW >= 0:
                # zero hits this deep means the density is propagation
                # territory — stop burning the uniform-draw budget
                # (PROPAGATE_BELOW < 0 pins pure rejection: benchmarks
                # and parity tests use it as the legacy baseline)
                break
            if got < m and self.constraints and self.PROPAGATE_BELOW >= 0 \
                    and self._accept_ewma < self.PROPAGATE_BELOW:
                # the EWMA sank below the threshold MID-call: a call that
                # entered on the rejection path (fresh space, EWMA still
                # converging) must not burn its whole draw budget there —
                # finish the remainder by propagation now. Loose spaces
                # never sink this low, so their streams stay byte-identical.
                try:
                    rest = self._sample_propagate(rng, m - got)
                except ValueError:
                    self._accept_ewma = ewma_entry
                    raise
                out.append(rest)
                got += len(rest)
                break
        if got == 0:
            if self.constraints and self.PROPAGATE_BELOW >= 0:
                try:
                    return self._sample_propagate(rng, m)
                except ValueError:
                    self._accept_ewma = ewma_entry
                    raise
            self._accept_ewma = ewma_entry
            raise ValueError(
                f"{self.name}: no feasible configuration in {attempts} "
                f"uniform draws — constraints too tight for rejection "
                f"sampling")
        codes = np.concatenate(out)[:m]
        if len(codes) < m:
            fill = codes[rng.integers(0, len(codes), size=m - len(codes))]
            codes = np.concatenate([codes, fill])
        return codes

    def stratified_feasible(self, rng: np.random.Generator, m: int,
                            rounds: int = 16) -> np.ndarray:
        """One feasible code per equal-width code stratum (coverage draws).

        Stratum edges use Python-int arithmetic — np.linspace would lose
        integer precision above 2**53. Strata that stay dry after ``rounds``
        rejection attempts fall back to global feasible draws. When the
        acceptance EWMA is below ``PROPAGATE_BELOW`` the rejection rounds
        are skipped entirely and each stratum is filled by an in-stratum
        propagating draw (digit-bounded backtracking), so coverage survives
        constraint densities where per-stratum rejection stays dry forever.
        """
        cart = self.cartesian_size
        m = int(min(m, cart))
        if m <= 0:
            return np.zeros(0, np.int64)
        out = np.full(m, -1, np.int64)
        unfilled = np.arange(m)
        propagate = bool(self.constraints) and \
            self._accept_ewma < self.PROPAGATE_BELOW
        if not propagate:
            seen_draws = seen_hits = 0
            for _ in range(rounds):
                if unfilled.size == 0:
                    break
                los = np.array([i * cart // m for i in unfilled], np.int64)
                his = np.array([(i + 1) * cart // m for i in unfilled],
                               np.int64)
                draws = rng.integers(los, his, dtype=np.int64)
                mask = self._feasible_mask(draws)
                out[unfilled[mask]] = draws[mask]
                unfilled = unfilled[~mask]
                seen_draws += int(draws.size)
                seen_hits += int(mask.sum())
                if self.constraints and self.PROPAGATE_BELOW >= 0 \
                        and seen_draws >= 4096 \
                        and seen_hits < self.PROPAGATE_BELOW * seen_draws:
                    # this call's own acceptance is propagation-tight:
                    # stop the per-stratum rejection rounds (they would
                    # stay dry and the global fill would pad duplicates)
                    # and fill the rest by in-stratum propagation. A local
                    # counter, not the EWMA — these draws must not perturb
                    # the adaptive batch state loose-space traces pin.
                    propagate = True
                    break
        if unfilled.size:
            if propagate:
                dry: List[int] = []
                for i in unfilled:
                    lo = int(i) * cart // m
                    hi = (int(i) + 1) * cart // m
                    code = (self._propagate_draw(rng, lo, hi)
                            if hi > lo else None)
                    if code is None:
                        dry.append(int(i))   # stratum truly infeasible
                    else:
                        out[int(i)] = code
                if dry:
                    out[np.asarray(dry, np.int64)] = \
                        self.sample_feasible(rng, len(dry))
            else:
                out[unfilled] = self.sample_feasible(rng, int(unfilled.size))
        return out

    def random_index(self, rng: np.random.Generator) -> int:
        return int(self.sample_feasible(rng, 1)[0])

    # -- constraint propagation (DESIGN.md §15) ------------------------------
    def _prop_init(self) -> None:
        """Discover each constraint's parameter dependencies by probing it
        with a key-recording config mapping (several value assignments, so
        value-conditional reads are likely caught), then bucket constraints
        by the declaration-order step at which their free variables become
        fully bound. A constraint whose reads the probe cannot see at all
        falls back to a full dependency set — it is then enforced by the
        leaf check instead of pruning."""
        if self._prop_by_step is not None:
            return
        name_to_j = {p.name: j for j, p in enumerate(self.params)}
        deps: List[Tuple[int, ...]] = []
        probes = ({p.name: p.values[0] for p in self.params},
                  {p.name: p.values[-1] for p in self.params},
                  {p.name: p.values[len(p.values) // 2] for p in self.params})
        for c in self.constraints:
            seen: set = set()
            for base in probes:
                try:
                    c(_DepProbe(base, seen))
                except Exception:
                    pass   # only the key reads matter, not the outcome
            dep = {name_to_j[n] for n in seen if n in name_to_j}
            deps.append(tuple(sorted(dep)) if dep
                        else tuple(range(self.dim)))
        self._prop_deps = deps
        self._prop_rebucket()

    def _prop_rebucket(self) -> None:
        by_step: List[List[int]] = [[] for _ in range(self.dim)]
        for ci, d in enumerate(self._prop_deps):
            by_step[max(d)].append(ci)
        self._prop_by_step = by_step

    def _register_dep(self, ci: int, name: str) -> None:
        """A constraint read a parameter the probe missed (conditional
        access surfacing at prune time as a KeyError): grow its dependency
        set and re-bucket. The in-flight pruning pass skips the constraint;
        the leaf check still enforces it."""
        j = next((k for k, p in enumerate(self.params)
                  if p.name == name), None)
        if j is None:
            return
        self._prop_deps[ci] = tuple(sorted(set(self._prop_deps[ci]) | {j}))
        self._prop_rebucket()

    def _prune_axis(self, bound: Sequence[int], j: int, cand: np.ndarray,
                    cons: Sequence[int]) -> np.ndarray:
        """Prune candidate ordinals for parameter ``j`` against the
        constraints in ``cons`` (each fully bound once ``j`` is chosen),
        given ``bound`` ordinals for every other dependency. Mirrors
        ``_constrain``'s declaration-order short-circuit, evaluated on the
        one free value column at a time."""
        for ci in cons:
            if cand.size == 0:
                break
            c = self.constraints[ci]
            n = len(cand)
            try:
                if isinstance(c, VectorConstraint):
                    cols: Dict[str, np.ndarray] = {}
                    for p_idx in self._prop_deps[ci]:
                        arr = self._value_arrays[p_idx]
                        if p_idx == j:
                            cols[self.params[p_idx].name] = arr[cand]
                        else:
                            cols[self.params[p_idx].name] = arr[
                                np.full(n, int(bound[p_idx]))]
                    cand = cand[c.mask(cols, n)]
                else:    # plain callable: per-candidate fallback
                    base = {self.params[p].name:
                            self.params[p].values[int(bound[p])]
                            for p in self._prop_deps[ci] if p != j}
                    keep = [int(v) for v in cand
                            if c({**base, self.params[j].name:
                                  self.params[j].values[int(v)]})]
                    cand = np.asarray(keep, np.int64)
            except KeyError as e:    # dependency probe missed a read
                self._register_dep(ci, str(e.args[0]) if e.args else "")
        return cand

    def _dead_add(self, prefix: Tuple[int, ...]) -> None:
        if len(self._dead_prefixes) >= DEAD_PREFIX_CACHE_MAX:
            self._dead_prefixes.pop(next(iter(self._dead_prefixes)))
        self._dead_prefixes[prefix] = None

    def _propagate_draw(self, rng: np.random.Generator,
                        lo: Optional[int] = None,
                        hi: Optional[int] = None) -> Optional[int]:
        """One feasible code by dimension-by-dimension constraint
        propagation with backtracking.

        Parameters are bound in declaration order; at step ``j`` the
        candidate grid is pruned by every constraint whose free variables
        are fully bound once ``j`` is chosen (``_prop_by_step``), then
        walked in rng-shuffled order. Dead prefixes are memoized FIFO so
        repeated draws amortize to near-O(params). A completed assignment
        is re-checked through ``_feasible_mask`` (the rejection sampler's
        exact verdict) — pruning is an accelerator, never the authority.
        With ``lo``/``hi`` the draw is confined to the code stratum
        ``[lo, hi)`` via mixed-radix digit bounds; range-truncated
        subtrees are never recorded as dead (a stratum dead-end is not a
        global one). Returns None when the (sub)tree has no feasible
        completion."""
        self._prop_init()
        bounded = lo is not None
        lo_d = (self.decode(np.asarray([lo], np.int64))[0]
                if bounded else None)
        hi_d = (self.decode(np.asarray([hi - 1], np.int64))[0]
                if bounded else None)
        last = self.dim - 1
        prefix: List[int] = []

        def rec(j: int, tlo: bool, thi: bool) -> bool:
            vmin = int(lo_d[j]) if tlo else 0
            vmax = int(hi_d[j]) if thi else int(self._nvals[j]) - 1
            cand = np.arange(vmin, vmax + 1, dtype=np.int64)
            cand = self._prune_axis(prefix, j, cand, self._prop_by_step[j])
            # permutation length depends only on the pruned grid, never on
            # the memo, so rng consumption is memo-state independent
            for t in rng.permutation(len(cand)):
                v = int(cand[int(t)])
                prefix.append(v)
                if tuple(prefix) in self._dead_prefixes:
                    prefix.pop()
                    continue
                if j == last:
                    code = int(np.asarray(prefix, np.int64)
                               @ self._strides)
                    if bool(self._feasible_mask(
                            np.asarray([code], np.int64))[0]):
                        return True
                elif rec(j + 1, tlo and v == int(lo_d[j]),
                         thi and v == int(hi_d[j])):
                    return True
                prefix.pop()
            if not (tlo or thi):
                self._dead_add(tuple(prefix))
            return False

        if not rec(0, bounded, bounded):
            return None
        self._prop_draws += 1
        return int(np.asarray(prefix, np.int64) @ self._strides)

    def _sample_propagate(self, rng: np.random.Generator,
                          m: int) -> np.ndarray:
        out = np.empty(m, np.int64)
        for i in range(m):
            code = self._propagate_draw(rng)
            if code is None:
                raise ValueError(
                    f"{self.name}: no feasible configuration — constraint "
                    f"propagation exhausted the grid")
            out[i] = code
        return out

    def axis_exchange(self, i: int, j: int) -> List[int]:
        """Coordinate-exchange move set along parameter ``j`` from feasible
        config ``i``, validated by the propagating per-dimension pruner:
        only the constraints that mention ``j`` are evaluated (the
        incumbent already satisfies the rest), on the whole candidate
        column at once — never by rejection draws."""
        self._prop_init()
        row = self.decode(np.asarray([int(i)], np.int64))[0]
        cand = np.arange(int(self._nvals[j]), dtype=np.int64)
        cand = cand[cand != int(row[j])]
        cons = [ci for ci, d in enumerate(self._prop_deps) if j in d]
        cand = self._prune_axis(row, j, cand, cons)
        codes = int(i) + (cand - int(row[j])) * int(self._strides[j])
        if codes.size:   # belt and braces against under-probed dependencies
            codes = codes[self._feasible_mask(codes)]
        return [int(c) for c in codes]

    # -- feasible-fraction estimation ----------------------------------------
    def _propagation_fraction_probes(self, n: int = 12) -> List[float]:
        """Knuth tree-size probes: each descent walks root->leaf WITHOUT
        backtracking, choosing uniformly among the pruned candidates at
        every level, and returns the product of per-dimension pruned-grid
        fractions (0.0 on a dead end). Each product is an unbiased
        estimator of the feasible fraction; min/max over probes bracket
        the sampled prefixes' evidence. Deterministically seeded so
        repeated calls (and repeated constructions) agree."""
        self._prop_init()
        rng = np.random.default_rng(self.ANCHOR_SEED ^ 0x9E3779B9)
        out: List[float] = []
        for _ in range(n):
            prefix: List[int] = []
            frac = 1.0
            for j in range(self.dim):
                cand = np.arange(int(self._nvals[j]), dtype=np.int64)
                cand = self._prune_axis(prefix, j, cand,
                                        self._prop_by_step[j])
                if cand.size == 0:
                    frac = 0.0
                    break
                frac *= len(cand) / int(self._nvals[j])
                prefix.append(int(cand[int(rng.integers(0, len(cand)))]))
            out.append(frac)
        return out

    def feasible_fraction_interval(self) -> Dict[str, float]:
        """Principled feasible-fraction estimate (DESIGN.md §15).

        With sampling stats: Jeffreys 95% interval over accepted/attempted
        uniform-draw counts. Before any sampling: propagation-derived
        bracket — min/mean/max of per-dimension pruned-grid fraction
        products along probe descents. Returns ``{method, point, lo, hi}``.
        """
        if not self.constraints:
            return {"method": "exact", "point": 1.0, "lo": 1.0, "hi": 1.0}
        if self._accept_draws:
            lo, hi = _jeffreys_interval(self._accept_hits,
                                        self._accept_draws)
            return {"method": "jeffreys",
                    "point": self._accept_hits / self._accept_draws,
                    "lo": lo, "hi": hi}
        probes = self._propagation_fraction_probes()
        return {"method": "propagation", "point": float(np.mean(probes)),
                "lo": float(min(probes)), "hi": float(max(probes))}

    # -- neighborhoods: feasible walks --------------------------------------
    def _neighbors(self, i: int, candidates_fn, csr_attr: str) -> List[int]:
        """Neighbor codes generated on the fly, validity-checked against the
        constraints, memoized FIFO exactly like the partial-CSR frontier.
        Candidate column order is inherited from the enumerated backend's
        generators, so parity tests can compare neighbor *sets* directly."""
        key = (csr_attr, int(i))
        hit = self._nbr_cache.get(key)
        if hit is None:
            code = np.asarray([int(i)], np.int64)
            cand, valid = candidates_fn(self.decode(code), code)
            cand = cand[0][valid[0]]
            hit = cand[self._feasible_mask(cand)]
            if len(self._nbr_cache) >= self._nbr_cache_max:
                self._nbr_cache.pop(next(iter(self._nbr_cache)))
            self._nbr_cache[key] = hit
        return hit.tolist()

    # -- nearest-point queries -----------------------------------------------
    def _round_codes(self, X: np.ndarray) -> np.ndarray:
        """[0,1]^d points -> codes of the per-dimension nearest grid rows."""
        ords = np.rint(np.asarray(X, np.float64) * self._norm_denom)
        ords = np.clip(ords, 0, self._nvals - 1).astype(np.int64)
        return ords @ self._strides

    def _anchors(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._anchor_codes is None:
            rng = np.random.default_rng(self.ANCHOR_SEED)
            n = int(min(self.ANCHOR_COUNT, self.cartesian_size))
            self._anchor_codes = np.unique(self.sample_feasible(rng, n))
            self._anchor_norm = self._norm_rows(
                self.decode(self._anchor_codes))
        return self._anchor_codes, self._anchor_norm

    def nearest_index(self, x_norm: np.ndarray,
                      exclude: Optional[set] = None,
                      chunk: int = 1 << 16) -> int:
        x = np.asarray(x_norm, np.float32)
        code = int(self._round_codes(x[None, :])[0])
        if (exclude is None or code not in exclude) and \
                self._find_code(code) is not None:
            return code
        anchors, anchor_norm = self._anchors()
        d2 = np.sum((anchor_norm - x[None, :]) ** 2, axis=1)
        if exclude:
            hit = np.isin(anchors, np.fromiter(exclude, np.int64,
                                               count=len(exclude)))
            d2[hit] = np.inf
        return int(anchors[int(np.argmin(d2))])

    def nearest_indices(self, X: np.ndarray, chunk: int = 1 << 16
                        ) -> np.ndarray:
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X[None, :]
        codes = self._round_codes(X)
        ok = self._feasible_mask(codes)
        if not ok.all():
            anchors, anchor_norm = self._anchors()
            bad = np.flatnonzero(~ok)
            d2 = (np.sum(X[bad] ** 2, axis=1)[:, None]
                  + np.sum(anchor_norm ** 2, axis=1)[None, :]
                  - 2.0 * (X[bad] @ anchor_norm.T))
            codes[bad] = anchors[np.argmin(d2, axis=1)]
        return codes

    @property
    def resident_bytes(self) -> int:
        total = (self._nvals.nbytes + self._strides.nbytes
                 + self._norm_denom.nbytes + self._norm_single.nbytes)
        if self._anchor_codes is not None:
            total += self._anchor_codes.nbytes + self._anchor_norm.nbytes
        for arr in self._nbr_cache.values():
            total += arr.nbytes
        return total

    def describe(self) -> str:
        # the feasible count is never enumerated here, so the fraction is a
        # loudly-labeled estimate: a Jeffreys interval over the rejection
        # sampler's accepted/attempted counts once draws exist, and before
        # any sampling a propagation-derived bracket (pruned-grid fraction
        # products along probe descents)
        est = self.feasible_fraction_interval()
        if est["method"] == "exact":
            frac = "feasible fraction 1 (unconstrained grid)"
        elif est["method"] == "jeffreys":
            frac = (f"feasible fraction ~{est['point']:.3g} "
                    f"(Jeffreys 95% [{est['lo']:.2g}, {est['hi']:.2g}] "
                    f"over {self._accept_hits}/{self._accept_draws} "
                    f"accepted/attempted uniform draws)")
        else:
            frac = (f"feasible fraction ~{est['point']:.3g} "
                    f"(PROPAGATION bound [{est['lo']:.2g}, {est['hi']:.2g}]"
                    f": pruned-grid fraction products along probe "
                    f"descents; no sampling stats yet)")
        lines = [f"GenerativeSpace {self.name}: cartesian "
                 f"{self.cartesian_size} ({self.dim} params, not enumerated; "
                 f"{frac})"]
        for p in self.params:
            vals = ", ".join(str(v) for v in p.values[:8])
            more = "..." if len(p.values) > 8 else ""
            lines.append(f"  {p.name}: [{vals}{more}] ({len(p.values)})")
        return "\n".join(lines)
