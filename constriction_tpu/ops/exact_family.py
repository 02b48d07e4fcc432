"""Reference-exact per-symbol continuous families: host tables and oracle.

The model tables are computed on the host with the exact f64 formulas of
the reference's ``LeakyQuantizer`` (models/quantized.py, golden-verified
against /root/reference/src/stream/model/quantize.rs:525-568), so a stream
coded against them is bit-compatible with a reference-produced model.

- Encode: 2 CDF evaluations per symbol give the per-symbol ``(cum, prob)``
  planes (:func:`exact_ecp`), which any ILANS2 encoder codes
  (interleaved2.encode_shared).
- Decode: the decoder cannot know the symbols, so it precomputes, per
  symbol position, a COMPACT exact description of the whole quantile
  partition: the LeakyQuantizer table is exactly LINEAR in both tails
  (where ``trunc(free * CDF(x - 1/2))`` is pinned at 0 / free-1, the
  boundary is ``b(s) = s - min`` resp. ``free - 1 + s - min``), so only the
  CORE boundaries (at most ``cmax`` of them, clamped analytically and
  verified exactly) are materialized (:func:`exact_boundary_tables`);
  :func:`decode_family_exact_host` inverts quantiles against them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils import special
from .interleaved import LaneConfig

EXACT_FAMILIES = ("gaussian", "laplace", "cauchy", "binomial")


def _cdf(family: str, x, mean, scale):
    """For the continuous families (mean, scale) are location/scale; for
    "binomial" the pair is (n_trials, p) -- same generic two-parameter slot
    convention as the native codec's DIST_KIND."""
    if family == "gaussian":
        return special.gaussian_cdf(x, mean, scale)
    if family == "laplace":
        return special.laplace_cdf(x, mean, scale)
    if family == "cauchy":
        return special.cauchy_cdf(x, mean, scale)
    if family == "binomial":
        return special.binomial_cdf(x, mean, scale)
    raise ValueError(f"unknown family {family!r}")


def _ppf_guess(family: str, p: float, mean, scale):
    """Approximate inverse CDF -- only a WINDOW GUESS; exactness comes from
    verifying the trunc values at the window edges."""
    mean = np.asarray(mean, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64)
    if family == "gaussian":
        from scipy.special import ndtri

        return mean + scale * ndtri(p)
    if family == "laplace":
        if p < 0.5:
            return mean + scale * np.log(2.0 * p)
        return mean - scale * np.log(2.0 * (1.0 - p))
    if family == "cauchy":
        return mean + scale * np.tan(np.pi * (p - 0.5))
    if family == "binomial":
        from scipy.special import ndtri

        mu = mean * scale  # n * p
        sd = np.sqrt(np.maximum(mean * scale * (1.0 - scale), 0.0))
        return mu + sd * ndtri(p)
    raise ValueError(family)


def _dedup_probe(mean, scale):
    """(unique_pairs, inverse) when a full exact-pair dedup is likely to
    pay, else None.  A 4096-point sample gates the O(n log n) np.unique --
    fully-continuous parameter batches (sampled unique fraction > 1/2)
    skip it entirely."""
    n = len(mean)
    if n >= 4096:
        step = max(n // 4096, 1)
        zs = mean[::step] + 1j * scale[::step]
        if len(np.unique(zs)) > len(zs) // 2:
            return None
    z = mean + 1j * scale
    uz, inv = np.unique(z, return_inverse=True)
    return (uz, inv) if len(uz) <= n // 2 else None



def exact_ncore(
    means, scales, family: str, min_sym: int, max_sym: int, precision: int,
) -> np.ndarray:
    """Per-symbol core sizes (number of non-linear boundaries) -- used to
    auto-size ``cmax`` before paying for the table fill.  Twin of the C++
    ``qm_core_edges`` bisection; numpy fallback below is bit-identical."""
    mean = np.asarray(means, dtype=np.float64).reshape(-1)
    scale = np.asarray(scales, dtype=np.float64).reshape(-1)
    n = len(mean)
    from .. import native

    if native.LIB is not None and family in EXACT_FAMILIES:
        # core size depends only on the (mean, scale) pair: probe unique
        # pairs once (parameter batches repeat pairs heavily)
        dd = _dedup_probe(mean, scale)
        if dd is not None:
            uz, inv = dd
            out_u = np.empty(len(uz), dtype=np.uint32)
            native.LIB.ctpu_exact_ncore(
                native.DIST_KIND[family], min_sym, max_sym, precision,
                np.ascontiguousarray(uz.real), np.ascontiguousarray(uz.imag),
                len(uz), out_u,
            )
            return out_u[inv]
        out = np.empty(n, dtype=np.uint32)
        native.LIB.ctpu_exact_ncore(
            native.DIST_KIND[family], min_sym, max_sym, precision,
            np.ascontiguousarray(mean), np.ascontiguousarray(scale), n, out,
        )
        return out

    # numpy twin: vectorized bisection on the monotone trunc value
    free = float((1 << precision) - 1 - (max_sym - min_sym))
    freeu = int(free)

    def tv(s):
        return _trunc(free * _cdf(family, s.astype(np.float64) - 0.5,
                                  mean, scale))

    def bisect(lo, hi, threshold):
        # batch bisection: lanes stop updating once hi - lo == 1 (a shared
        # loop over the max lane width; converged lanes are masked)
        while np.any(hi - lo > 1):
            active = (hi - lo) > 1
            mid = lo + ((hi - lo) >> 1)
            pred = tv(mid) >= threshold
            hi = np.where(active & pred, mid, hi)
            lo = np.where(active & ~pred, mid, lo)
        return hi

    tv_max = tv(np.full(n, max_sym, np.int64))
    # core_lo: first s in (min, max] with tv >= 1 (max_sym when none)
    hi = bisect(np.full(n, min_sym, np.int64),
                np.full(n, max_sym, np.int64), 1)
    core_lo = np.where(tv_max < 1, max_sym, hi)
    # core_hi: last s with tv <= free-1 == (first s with tv >= free) - 1
    hi = bisect(np.full(n, min_sym + 1, np.int64),
                np.full(n, max_sym, np.int64), freeu)
    tv_lo1 = tv(np.full(n, min_sym + 1, np.int64))
    core_hi = np.where(
        tv_max <= freeu - 1, max_sym,
        np.where(tv_lo1 >= freeu, min_sym, hi - 1),
    )
    core_hi = np.maximum(core_hi, core_lo)
    return (core_hi - core_lo + 1).astype(np.uint32)


def _trunc(x: np.ndarray) -> np.ndarray:
    """Truncating f64 -> u32 cast with Rust `as` semantics (saturating,
    NaN -> 0); twin of models/quantized._trunc_to_uint."""
    hi = float((1 << 32) - 1)
    with np.errstate(invalid="ignore"):
        clipped = np.clip(x, 0.0, hi)
        clipped = np.where(np.isnan(x), 0.0, clipped)
    return np.trunc(clipped).astype(np.int64)


def exact_ecp(
    symbols, means, scales, family: str, min_sym: int, max_sym: int,
    precision: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-symbol (cum, prob) with the exact reference formulas
    (quantize.rs:525-568), vectorized over per-symbol (mean, scale)."""
    s = np.asarray(symbols, dtype=np.int64)
    if np.any((s < min_sym) | (s > max_sym)):
        raise ValueError("symbol outside support")
    mean = np.asarray(means, dtype=np.float64)
    scale = np.asarray(scales, dtype=np.float64)
    free = float((1 << precision) - 1 - (max_sym - min_sym))
    if free < 1.0:
        raise ValueError("support too large for precision")
    from .. import native

    if (
        native.LIB is not None
        and family in EXACT_FAMILIES
        and mean.ndim == 1
        and len(s) == len(mean)
        and len(s) >= 64
    ):
        # same per-symbol formulas in C++ (glibc libm, bit-identical to the
        # numpy path below); ~100x the numpy/frompyfunc throughput
        cums32 = np.empty(len(s), dtype=np.uint32)
        probs32 = np.empty(len(s), dtype=np.uint32)
        err = native.LIB.ctpu_quantized_ecp(
            native.DIST_KIND[family], min_sym, max_sym, precision,
            np.ascontiguousarray(s, dtype=np.int32),
            np.ascontiguousarray(mean), np.ascontiguousarray(scale),
            len(s), cums32, probs32,
        )
        if err != 0 or np.any((probs32 - 1) >= np.uint32(1 << precision)):
            # twin of the numpy path's prob <= 0 check (a wrapped
            # right - left shows up as a huge u32 here)
            raise ValueError("invalid underlying continuous distribution")
        return cums32, probs32
    slack = s - min_sym
    sf = s.astype(np.float64)
    left = _trunc(free * _cdf(family, sf - 0.5, mean, scale)) + slack
    left = np.where(s == min_sym, 0, left)
    right = _trunc(free * _cdf(family, sf + 0.5, mean, scale)) + slack + 1
    right = np.where(s == max_sym, 1 << precision, right)
    prob = right - left
    if np.any(prob <= 0):
        raise ValueError("invalid underlying continuous distribution")
    return left.astype(np.uint32), prob.astype(np.uint32)


def exact_boundary_tables(
    means, scales, family: str, min_sym: int, max_sym: int, precision: int,
    cmax: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Compact exact decode tables: per symbol position, the core boundary
    values ``b(s) = trunc(free * CDF(s - 1/2)) + (s - min)`` for s in
    [core_lo, core_hi], where the core is the maximal range outside which
    the trunc value is exactly 0 (left tail) or free-1 (right tail).

    Returns ``(aux u32[n], core u32[n, cmax])``.  For P <= 16 ("narrow"
    tables) ``aux = (core_lo - min) |
    ncore << 16`` and pads are 0xFFFF; for 16 < P <= 24 ("wide" tables,
    the default-preset precisions)
    ``aux = (core_lo - min) | ncore << 24`` and pads are ``1 << P`` — a
    value no real boundary can take (they are <= 2^P - 2) that doubles as
    the no-next-boundary sentinel, so the pads need no masking at all.
    Raises if any symbol's core exceeds ``cmax`` (increase cmax; a very
    flat distribution can make the whole support non-linear).
    """
    mean = np.asarray(means, dtype=np.float64).reshape(-1)
    scale = np.asarray(scales, dtype=np.float64).reshape(-1)
    n = len(mean)
    P = precision
    assert P <= 24, "exact tables support precisions up to 24"
    wide = P > 16
    padv = (1 << P) if wide else 0xFFFF
    aux_shift = 24 if wide else 16
    if cmax is None:
        # auto-size: probe per-symbol core sizes (2 bisections each, no
        # value fill), then use the tight max -- table bytes and the
        # inversion scan both cost O(cmax)
        ncore = exact_ncore(mean, scale, family, min_sym, max_sym, P)
        cmax = max(int(ncore.max()) if n else 1, 1)
        if not wide:
            cmax += cmax & 1  # narrow tables pack boundary PAIRS
        if cmax >= (1 << (32 - aux_shift)):
            raise ValueError(
                f"core needs {cmax} boundaries; the {'wide' if wide else 'narrow'}"
                f" table format caps ncore at {(1 << (32 - aux_shift)) - 1}"
                " (use the host decode path for this model)"
            )
    assert cmax < (1 << (32 - aux_shift))
    free = float((1 << P) - 1 - (max_sym - min_sym))
    if free < 2.0:
        raise ValueError("support too large for precision")
    span = max_sym - min_sym

    # native path: per-edge bisection in C++ (glibc libm, bit-identical),
    # log2(span) CDF evals per edge instead of a full evaluation window;
    # the C++ generator emits the same narrow/wide pad + aux packing
    from .. import native

    if native.LIB is not None and family in EXACT_FAMILIES:
        aux = np.empty(n, dtype=np.uint32)
        core = np.empty((n, cmax), dtype=np.uint32)
        bad = native.LIB.ctpu_exact_boundaries(
            native.DIST_KIND[family], min_sym, max_sym, P,
            np.ascontiguousarray(mean), np.ascontiguousarray(scale),
            n, cmax, aux, core.reshape(-1),
        )
        if bad:
            raise ValueError(
                f"core of symbol {int(bad) - 1} needs more than cmax={cmax} "
                "boundaries; increase cmax (flat distributions make the "
                "whole support non-linear)"
            )
        return aux, core

    # window guess from the approximate PPF, with margin; exactness is then
    # verified on the evaluated trunc values at the window edges
    margin = 4
    wwin = min(cmax + 2 * margin, span + 1)
    lo_g = np.floor(_ppf_guess(family, 1.0 / free, mean, scale))
    lo_g = np.where(np.isfinite(lo_g), lo_g, float(min_sym))
    a = np.clip(
        lo_g.astype(np.int64) - margin, min_sym + 1, max(min_sym + 1, max_sym - wwin + 1)
    )
    grid = a[:, None] + np.arange(wwin)[None, :]  # [n, wwin] symbol values
    valid = grid <= max_sym
    gridc = np.minimum(grid, max_sym)
    tv = _trunc(
        free * _cdf(family, gridc.astype(np.float64) - 0.5,
                    mean[:, None], scale[:, None])
    )
    # cdf rounds to exactly 1.0 in f64 well inside heavy right tails, so
    # trunc(free * cdf) takes the value free there (NOT free-1); the single
    # right-linear regime is b(s) = free + s - min, and everything below
    # saturation (including the trunc == free-1 stretch) belongs to the core
    pos = (tv >= 1) & valid
    nonsat = (tv <= int(free) - 1) & valid

    any_pos = pos.any(axis=1)
    lo_w = np.where(any_pos, pos.argmax(axis=1), wwin - 1)
    # window-edge verification: the first positive trunc must be INSIDE the
    # window (edge value 0) unless the window starts at the support edge
    edge_ok = (~any_pos) | (lo_w > 0) | (a == min_sym + 1)
    if not np.all(edge_ok):
        raise ValueError(
            "core window missed the left edge (distribution wider than "
            f"cmax={cmax}? increase cmax)"
        )
    any_ns = nonsat.any(axis=1)
    hi_w = np.where(any_ns, wwin - 1 - nonsat[:, ::-1].argmax(axis=1), lo_w)
    # the right edge is covered when the last non-saturated value is inside
    # the window (something saturated/invalid follows it) OR the window
    # already reaches the end of the support (a core touching max is fine)
    hi_ok = (hi_w < wwin - 1) | (grid[:, wwin - 1] >= max_sym)
    if not np.all(hi_ok):
        raise ValueError(
            "core window missed the right edge (distribution wider than "
            f"cmax={cmax}? increase cmax)"
        )
    # clamp to a non-empty core (all-linear / sharp-step cases)
    lo_w = np.where(any_pos, lo_w, np.minimum(max_sym - a, wwin - 1))
    hi_w = np.maximum(hi_w, lo_w)
    ncore = hi_w - lo_w + 1
    if np.any(ncore > cmax):
        raise ValueError(
            f"core needs {int(ncore.max())} boundaries > cmax={cmax}; "
            "increase cmax (flat distributions make the whole support "
            "non-linear)"
        )

    b = tv + (gridc - min_sym)  # boundary values on the window grid
    idx = lo_w[:, None] + np.arange(cmax)[None, :]
    take = np.take_along_axis(
        np.concatenate([b, np.full((n, cmax), padv, np.int64)], axis=1),
        np.minimum(idx, wwin + cmax - 1),
        axis=1,
    )
    core = np.where(np.arange(cmax)[None, :] < ncore[:, None], take, padv)
    core_lo_rel = (np.take_along_axis(grid, lo_w[:, None], 1)[:, 0] - min_sym)
    aux = (core_lo_rel.astype(np.uint32)
           | (ncore.astype(np.uint32) << aux_shift))
    return aux, core.astype(np.uint32)


def _invert_with_tables(q, aux, core, min_sym, max_sym, precision):
    """Vectorized quantile inversion from (aux, core) tables (tails in
    closed form, the core by a boundary scan).  q, aux: [L];
    core: [L, cmax]."""
    P = precision
    free = (1 << P) - 1 - (max_sym - min_sym)
    span = max_sym - min_sym
    wide = P > 16
    aux_shift = 24 if wide else 16
    q = q.astype(np.int64)
    cl = (aux & ((1 << aux_shift) - 1)).astype(np.int64)
    nc = (aux >> aux_shift).astype(np.int64)
    c = core.astype(np.int64)  # pads: 0xFFFF (narrow) / 2^P (wide)
    # Real boundaries can reach 2^P - 1 (a clamped sharp-step core holds
    # the saturated b = free + s_rel), so pads cannot be told apart by
    # value alone — at P = 16 a real 0xFFFF boundary would collide with the
    # narrow pad, and q itself can be 0xFFFF.  Mask by index instead: entry
    # j is real iff j < ncore.  The no-next sentinel is 2^P (which is also
    # exactly the wide pad value).
    real = np.arange(core.shape[1])[None, :] < nc[:, None]
    le = (c <= q[:, None]) & real
    cnt = le.sum(axis=1)
    cumc = np.where(le, c, 0).max(axis=1)
    nxtc = np.where(le | ~real, 1 << P, c).min(axis=1)
    core_hi_rel = cl + nc - 1
    rstart = np.where(
        core_hi_rel >= span, 1 << P, free + core_hi_rel + 1
    )
    # left-linear region
    s_rel_l = np.minimum(q, cl - 1)
    next_l = np.where(s_rel_l >= cl - 1, nxtc, s_rel_l + 1)
    # core region
    sym_c = cl + cnt - 1
    next_c = np.minimum(nxtc, rstart)
    # right-linear region (saturated: b(s) = free + s - min)
    s_rel_r = np.minimum(q - free, span)
    cum_r = free + s_rel_r
    next_r = np.where(s_rel_r >= span, 1 << P, cum_r + 1)

    right = q >= rstart
    leftr = cnt == 0
    s_rel = np.where(right, s_rel_r, np.where(leftr, s_rel_l, sym_c))
    cum = np.where(right, cum_r, np.where(leftr, s_rel_l, cumc))
    nxt = np.where(right, next_r, np.where(leftr, next_l, next_c))
    return (
        (s_rel + min_sym).astype(np.int64),
        cum.astype(np.uint64),
        (nxt - cum).astype(np.uint64),
    )


def decode_family_exact_host(
    init_states, stream, means, scales, family: str, min_sym: int,
    max_sym: int, cfg: LaneConfig, num_symbols: int, cmax: int | None = None,
) -> np.ndarray:
    """Numpy oracle for the exact-family decoder (same schedule as
    ops/interleaved2.decode_shared_cdf, per-symbol tables)."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-num_symbols // L) if num_symbols else 0
    lower = np.uint64(1 << (S - W))
    aux_all, core_all = exact_boundary_tables(
        *_pad_params(means, scales, T * L, family, max_sym), family,
        min_sym, max_sym, P, cmax,
    )
    states = np.asarray(init_states).astype(np.uint64)
    base = 0
    out = np.empty(T * L, dtype=np.int64)
    lanes = np.arange(L)
    stream = np.asarray(stream)
    for t in range(T):
        idx = t * L + lanes
        active = idx < num_symbols
        q = states & np.uint64((1 << P) - 1)
        sym, cum, prob = _invert_with_tables(
            q.astype(np.int64), aux_all[idx], core_all[idx],
            min_sym, max_sym, P,
        )
        new_states = (states >> np.uint64(P)) * prob + (q - cum)
        states = np.where(active, new_states, states)
        m = states < lower
        k = int(m.sum())
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = stream[base : base + k]
            words[: len(avail)] = avail
            states[m] = (states[m] << np.uint64(W)) | words
            base += k
        out[idx] = sym
    return out[:num_symbols]


def _pad_to(arr, n, fill=0.0):
    arr = np.asarray(arr, dtype=np.float64).reshape(-1)
    if len(arr) >= n:
        return arr[:n]
    out = np.full(n, fill, np.float64)
    out[: len(arr)] = arr
    return out


def _pad_params(means, scales, n, family, max_sym):
    """Pad (mean, scale) slots for inactive tail lanes.  The continuous
    families take a unit model at the origin; binomial's slots are
    (n_trials, p), where (0, 1) would be degenerate (lgamma poles), so pad
    with (max_sym trials, p=1/2)."""
    if family == "binomial":
        return (_pad_to(means, n, float(max_sym)), _pad_to(scales, n, 0.5))
    return _pad_to(means, n), _pad_to(scales, n, 1.0)
