"""Flagship benchmark: the i.i.d. categorical rANS coder on one NVIDIA GPU.

    python bench.py [--seed 1234] [--reps 11] [--routes cuda,xla]

The workload is the flagship cell: 2^24 i.i.d. symbols over 32768 lanes
from a K=100 Dirichlet(2) categorical model made from ``--seed``, at both
presets the facade picks (P=12/W=16/S=32 and P=24/W=32/S=64).  For every
route of the device coder (ops/route.py) it measures:

- end to end, the way a caller pays: ``tpu.encode_iid`` from host symbols
  to container bytes (compact v2, the default, and v1), and
  ``tpu.decode_iid`` back, the routes taking turns call by call, with the
  median of the paired differences;
- the device coder alone: one jitted encode or decode over inputs already
  on the device, ended by ``block_until_ready``.

Every round trip is checked byte for byte against the host oracle.  Times
are medians of ``--reps`` runs with their (min, max).  Without a GPU the
script exits 1 and prints no result.  The last line is one JSON object
naming the card, its power limit and every number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchmarks import common  # noqa: E402

PRESETS = ((12, 16, 32), (24, 32, 64))


def device_coder_times(cfg, syms, cdf, st, stream, reps):
    """Median (min, max) seconds of one jitted device encode and decode
    whose inputs already live on the device."""
    import jax
    import jax.numpy as jnp

    from constriction_tpu.ops import device_coder as dc
    from constriction_tpu.ops import route

    L, n = cfg.num_lanes, len(syms)
    T = -(-n // L)
    r = route.coder_route()
    with dc._x64(cfg):
        dt = jnp.uint64 if cfg.state_bits > 32 else jnp.uint32
        put = jax.device_put
        sym_d = put(np.pad(syms.astype(np.int32), (0, T * L - n))[None])
        seeds = put(jnp.full((1, L), 1 << (cfg.state_bits - cfg.word_bits), dt))
        cdf_d = put(np.asarray(cdf, np.uint32))
        nsym = put(np.array([n], np.int32))
        words = put(np.asarray(stream, np.uint32)[None])
        lens = put(np.array([len(stream)], np.int32))
        st_d = put(np.asarray(st)[None].astype(dt))
        tbl = put(dc._decode_table(r, cdf, cfg.precision))
        enc = dc._encode_fn(r, cfg, T, None)
        dec = dc._decode_fn(r, cfg, T, None)
        t_enc = common.timed(
            lambda: jax.block_until_ready(enc(sym_d, seeds, cdf_d, nsym)), reps)
        t_dec = common.timed(
            lambda: jax.block_until_ready(
                dec(st_d, words, lens, cdf_d, tbl, nsym)), reps)
    return t_enc, t_dec


def paired(fns: dict, reps: int) -> dict:
    """Time each route's call ``reps`` times, the routes taking turns
    (order reversed every other round).  Returns per route the median and
    (min, max) seconds, and the median of the per-round differences
    against the first route."""
    import time

    from constriction_tpu.ops import route

    names = list(fns)
    for r in names:
        with route.forced(r):
            fns[r]()
    ts = {r: [] for r in names}
    for i in range(reps):
        for r in (names if i % 2 == 0 else names[::-1]):
            with route.forced(r):
                t0 = time.perf_counter()
                fns[r]()
                ts[r].append(time.perf_counter() - t0)
    med = {r: float(np.median(ts[r])) for r in names}
    out = {r: {"median_s": med[r], "range_s": [min(ts[r]), max(ts[r])]}
           for r in names}
    for r in names[1:]:
        out[r]["minus_" + names[0] + "_s"] = float(
            np.median(np.subtract(ts[r], ts[names[0]])))
    return out


def measure(routes, P, W, S, syms, cdf, reps):
    """End-to-end (compact v2 and v1 containers) and device-coder times
    per route; every container is checked against the host oracle."""
    import constriction_tpu.tpu as ctpu
    from constriction_tpu.ops import framing
    from constriction_tpu.ops import interleaved2 as il2
    from constriction_tpu.ops import route
    from constriction_tpu.ops.interleaved import LaneConfig

    cfg = LaneConfig(num_lanes=common.FLAGSHIP_LANES, word_bits=W,
                     state_bits=S, precision=P)
    res = {}
    for compact, host in (
            (True, framing.encode_iid_v2(syms, cdf, cfg, device=False)),
            (False, il2.encode_iid_categorical2(syms, cdf, cfg,
                                                device=False))):
        tag = "v2" if compact else "v1"
        for r in routes:
            with route.forced(r):
                cont = ctpu.encode_iid(syms, cdf, cfg, compact=compact)
                if not np.array_equal(cont, host):
                    raise SystemExit(f"P={P} {r} {tag}: container != host")
                if not np.array_equal(ctpu.decode_iid(cont, cdf), syms):
                    raise SystemExit(f"P={P} {r} {tag}: round trip mismatch")
        res[f"encode_iid_{tag}"] = paired(
            {r: (lambda: ctpu.encode_iid(syms, cdf, cfg, compact=compact))
             for r in routes}, reps)
        res[f"decode_iid_{tag}"] = paired(
            {r: (lambda: ctpu.decode_iid(host, cdf)) for r in routes}, reps)
    p = framing.parse_v2(framing.encode_iid_v2(syms, cdf, cfg, device=False))
    for r in routes:
        with route.forced(r):
            (enc, enc_rng), (dec, dec_rng) = device_coder_times(
                p.cfg, syms[: p.n_A], cdf, p.states_A, p.stream_A, reps)
        res.setdefault("device_encode", {})[r] = {"median_s": enc,
                                                  "range_s": list(enc_rng)}
        res.setdefault("device_decode", {})[r] = {"median_s": dec,
                                                  "range_s": list(dec_rng)}
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--reps", type=int, default=11)
    ap.add_argument("--routes", default="cuda,xla")
    args = ap.parse_args()
    routes = args.routes.split(",")

    dev = common.require_gpu()
    import jax

    card = common.card()
    print(card, flush=True)
    common.enable_compile_cache()
    n = common.FLAGSHIP_SYMBOLS
    results = {}
    for (P, W, S) in PRESETS:
        syms, cdf = common.flagship(args.seed, P)
        res = measure(routes, P, W, S, syms, cdf, args.reps)
        results[f"P{P}"] = res
        for what, per_route in res.items():
            line = "; ".join(
                f"{r} {v['median_s'] * 1e3:.3f} ms "
                f"[{v['range_s'][0] * 1e3:.3f}, {v['range_s'][1] * 1e3:.3f}]"
                + (f" ({r} - {routes[0]}: "
                   f"{v['minus_' + routes[0] + '_s'] * 1e3:+.3f} ms)"
                   if "minus_" + routes[0] + "_s" in v else "")
                for r, v in per_route.items())
            print(f"P={P} {what}: {line}", flush=True)

    head = results["P24"]["decode_iid_v2"][routes[0]]["median_s"]
    print(json.dumps({
        "metric": f"decode_iid symbols/s, P=24, 2^24 symbols, L=32768, "
                  f"route {routes[0]}",
        "value": n / head,
        "unit": "symbols/s",
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "results": results,
    }), flush=True)


if __name__ == "__main__":
    main()
