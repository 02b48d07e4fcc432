"""Quickest proof that the system runs on an NVIDIA GPU.

    python chip_smoke.py          # one card: the main path, phases 1-5
    python chip_smoke.py --four   # four cards: the sharded container only

The main path is the i.i.d. categorical rANS coder through its normal
entry points (``constriction_tpu.tpu.encode_iid`` / ``decode_iid``), at
both presets the facade picks -- P=12/W=16/S=32 and P=24/W=32/S=64 -- on
the flagship workload: 2^24 symbols over 32768 lanes from a K=100
Dirichlet(2) model made from ``--seed``.

Phases (any failure exits non-zero before the result line):

1. build the CUDA kernels, compile the device coder at full size and print
   each program's memory analysis;
2. ``encode_iid`` -> ``decode_iid`` round trips, compact (v2) and v1; the
   container bytes must equal the host oracle's;
3. checkpoint resume from the middle of each container;
4. the kernel route against the plain-XLA route, byte for byte;
5. the tests marked ``gpu``, through ``pytest.main`` in this process.

``--four`` runs only ``parallel.encode`` / ``decode`` on a 4-device mesh,
compact and raw, at both presets, against the host-built container.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchmarks import common  # noqa: E402

PRESETS = ((12, 16, 32), (24, 32, 64))


def _phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _done(t0):
    print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def _cfg(P, W, S, L=common.FLAGSHIP_LANES):
    from constriction_tpu.ops.interleaved import LaneConfig

    return LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=P)


def _check(ok, what):
    if not ok:
        raise SystemExit(f"FAILED: {what}")
    print(f"   ok: {what}", flush=True)


def compile_phase(data):
    import jax
    import jax.numpy as jnp

    from constriction_tpu import cuda
    from constriction_tpu.ops import device_coder as dc

    t = time.perf_counter()
    cuda.build(verbose=True)
    print(f"   nvcc build: {time.perf_counter() - t:.1f} s", flush=True)
    for (P, W, S) in PRESETS:
        cfg = _cfg(P, W, S)
        syms, cdf = data[P]
        L, n = cfg.num_lanes, len(syms)
        T = -(-n // L)
        st = jnp.uint64 if S > 32 else jnp.uint32
        sds = jax.ShapeDtypeStruct
        cdf_s = sds((len(cdf),), jnp.uint32)
        nsym = sds((1,), jnp.int32)
        with dc._x64(cfg):
            for route in ("cuda", "xla"):
                tbl = dc._decode_table(route, cdf, P)
                dec = dc._decode_fn(route, cfg, T, None).lower(
                    sds((1, L), st), sds((1, T * L), jnp.uint32),
                    sds((1,), jnp.int32), cdf_s, sds(tbl.shape, tbl.dtype),
                    nsym).compile()
                enc = dc._encode_fn(route, cfg, T, None).lower(
                    sds((1, T * L), jnp.int32), sds((1, L), st), cdf_s,
                    nsym).compile()
                for name, c in (("decode", dec), ("encode", enc)):
                    m = c.memory_analysis()
                    print(f"   P={P} {route:4s} {name}: args "
                          f"{m.argument_size_in_bytes} B, out "
                          f"{m.output_size_in_bytes} B, temp "
                          f"{m.temp_size_in_bytes} B", flush=True)


def facade_phase(data):
    import constriction_tpu.tpu as ctpu
    from constriction_tpu.ops import framing
    from constriction_tpu.ops import interleaved2 as il2

    containers = {}
    for (P, W, S) in PRESETS:
        cfg = _cfg(P, W, S)
        syms, cdf = data[P]
        for compact in (True, False):
            t = time.perf_counter()
            cont = ctpu.encode_iid(syms, cdf, cfg, compact=compact)
            t_enc = time.perf_counter() - t
            t = time.perf_counter()
            out = ctpu.decode_iid(cont, cdf)
            t_dec = time.perf_counter() - t
            host = (framing.encode_iid_v2(syms, cdf, cfg, device=False)
                    if compact else
                    il2.encode_iid_categorical2(syms, cdf, cfg, device=False))
            tag = f"P={P} {'v2' if compact else 'v1'}"
            print(f"   {tag}: encode_iid {t_enc:.3f} s, decode_iid "
                  f"{t_dec:.3f} s (first call, compile included), "
                  f"{len(cont) * 4} bytes", flush=True)
            _check(np.array_equal(cont, host), f"{tag} container == host bytes")
            _check(np.array_equal(out, syms), f"{tag} round trip")
            containers[(P, compact)] = cont
    return containers


def checkpoint_phase(data, containers):
    import constriction_tpu.tpu as ctpu

    interval = 64
    for (P, W, S) in PRESETS:
        syms, cdf = data[P]
        for compact in (True, False):
            cont = containers[(P, compact)]
            offsets, states = ctpu.build_checkpoints(cont, cdf, interval)
            c = len(offsets) // 2
            start, suffix = ctpu.decode_from_checkpoint(
                cont, cdf, interval, c, offsets, states)
            _check(np.array_equal(suffix, syms[start:]),
                   f"P={P} {'v2' if compact else 'v1'} resume at symbol "
                   f"{start} of {len(syms)}")


def route_phase(data):
    from constriction_tpu.ops import device_coder as dc
    from constriction_tpu.ops import route

    for (P, W, S) in PRESETS:
        cfg = _cfg(P, W, S)
        syms, cdf = data[P]
        res = {}
        for r in ("cuda", "xla"):
            with route.forced(r):
                st, w = dc.encode(syms, cdf, cfg)
                out, fin = dc.decode(st, w, len(syms), cdf, cfg,
                                     return_final_states=True)
                res[r] = (st, w, out, fin)
        c, x = res["cuda"], res["xla"]
        _check(all(np.array_equal(a, b) for a, b in zip(c, x)),
               f"P={P} cuda route == xla route (states, stream, symbols, "
               "final states)")
        _check(np.array_equal(c[2], syms), f"P={P} cuda decode")


def pytest_phase():
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests", "test_gpu_kernels.py")])
    _check(rc == 0, f"pytest -m gpu (exit code {int(rc)})")


def four_phase(seed):
    import jax

    from constriction_tpu import parallel

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX found {len(jax.devices())}")
    mesh = parallel.make_mesh(4)
    for (P, W, S) in PRESETS:
        syms, cdf = common.flagship(seed, P)
        cfg = _cfg(P, W, S)
        for compact in (False, True):
            tag = f"P={P} {'compact' if compact else 'raw'}"
            t = time.perf_counter()
            cont = parallel.encode(syms, cdf, cfg=cfg, num_blocks=8,
                                   mesh=mesh, compact=compact)
            t_enc = time.perf_counter() - t
            host = parallel.encode(syms, cdf, cfg=cfg, num_blocks=8,
                                   device=False, compact=compact)
            t = time.perf_counter()
            out = parallel.decode(cont, cdf, mesh=mesh)
            t_dec = time.perf_counter() - t
            print(f"   {tag}: encode {t_enc:.3f} s, decode {t_dec:.3f} s "
                  "(first call, compile included)", flush=True)
            _check(np.array_equal(cont, host), f"{tag} container == host bytes")
            _check(np.array_equal(out, syms), f"{tag} round trip on 4 devices")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded container on 4 GPUs")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()

    dev = common.require_gpu()
    import jax

    print(common.card(), flush=True)
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    print(f"compile cache: {common.enable_compile_cache()}", flush=True)

    if args.four:
        t = _phase("sharded container on 4 devices")
        four_phase(args.seed)
        _done(t)
    else:
        t = _phase("data")
        data = {P: common.flagship(args.seed, P) for (P, _, _) in PRESETS}
        _done(t)
        t = _phase("1. build and compile")
        compile_phase(data)
        _done(t)
        t = _phase("2. encode_iid / decode_iid against the host oracle")
        containers = facade_phase(data)
        _done(t)
        t = _phase("3. checkpoint resume")
        checkpoint_phase(data, containers)
        _done(t)
        t = _phase("4. kernel route against the XLA route")
        route_phase(data)
        _done(t)
        t = _phase("5. tests marked gpu")
        pytest_phase()
        _done(t)

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
