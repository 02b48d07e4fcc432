"""Benchmark suite: the categorical rANS coder across entropies and presets.

    python benchmarks/suite.py [--seed 1234] [--reps 3]

Needs an NVIDIA GPU (exits 1 otherwise).  Each row codes 2^24 i.i.d.
symbols (K=100) and reports:

- entropy: the true sampling model's information per symbol;
- total overhead: compact (v2) container bits over that information - 1
  (the model-quantization loss counts, as in the reference's published
  methodology, constriction README.md:202-205);
- marginal overhead: the asymptotic per-symbol overhead, from rANS
  near-conservation differenced over two message lengths (accurate to
  ~1e-4 %);
- vs reference size: container bytes over the bytes of the reference's
  own framing (the host AnsCoderCore, bit-exact with constriction's
  DefaultAnsCoder) on the same (cum, prob) sequence;
- encode_iid / decode_iid: end-to-end medians through the facade;
- device encode / decode: the device coder alone, inputs on the card,
  in symbols per second.

Rows: P=12 at low / mid / high entropy; the DEFAULT preset (P=24); a
low-entropy message through the facade's own lane choice; the rate-parity
configuration (L=128, P=24); the sharded container over every device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import common  # noqa: E402

N = common.FLAGSHIP_SYMBOLS
K = common.FLAGSHIP_ALPHABET


def _entropy_model(kind: str, rng):
    if kind == "low":
        p = np.full(K, 1e-4)
        p[0] = 1.0
        return p / p.sum()
    if kind == "high":
        return rng.dirichlet(np.full(K, 50.0))
    return rng.dirichlet(np.full(K, 2.0))


def _marginal(cums, probs, cfg, info_bits_half, W):
    """Asymptotic overhead: W * d(words) + d(sum log2 states) over the
    information of the second half of the message, minus one."""
    from constriction_tpu.ops import interleaved2 as il2

    n = len(cums)
    st_f, w_f = il2.encode_shared(cums, probs, cfg)
    st_h, w_h = il2.encode_shared(cums[: n // 2], probs[: n // 2], cfg)
    c_f = np.sum(np.log2(np.asarray(st_f, np.float64)))
    c_h = np.sum(np.log2(np.asarray(st_h, np.float64)))
    return ((len(w_f) - len(w_h)) * W + (c_f - c_h)) / info_bits_half - 1.0


def _ref_bits(cums, probs, P):
    from constriction_tpu.ops.ans import AnsCoderCore

    ref = AnsCoderCore(word_bits=32, state_bits=64)
    ref.encode_reverse_tables(cums.astype(np.uint32), probs.astype(np.uint32),
                              P)
    return len(ref.get_compressed()) * 32


def row(name, symbols, p_true, cdf, cfg, reps, device_times=True):
    import constriction_tpu.tpu as ctpu
    from constriction_tpu.ops import framing

    import bench

    c64 = np.asarray(cdf, np.uint64)
    cums, probs = c64[symbols], c64[symbols + 1] - c64[symbols]
    info = -np.log2(p_true[symbols])
    cont = ctpu.encode_iid(symbols, cdf, cfg)
    assert np.array_equal(ctpu.decode_iid(cont, cdf), symbols), name
    p = framing.parse_v2(cont)
    out = {
        "workload": name,
        "L": p.cfg.num_lanes,
        "entropy_bits": float(info.mean()),
        "overhead_pct": 100 * (len(cont) * 32 / info.sum() - 1),
        "marginal_overhead_pct": 100 * _marginal(
            cums, probs, p.cfg, info[len(info) // 2:].sum(),
            p.cfg.word_bits),
        "vs_reference_size": len(cont) * 32 / _ref_bits(cums, probs,
                                                        p.cfg.precision),
        "encode_iid_s": common.timed(
            lambda: ctpu.encode_iid(symbols, cdf, cfg), reps)[0],
        "decode_iid_s": common.timed(lambda: ctpu.decode_iid(cont, cdf),
                                     reps)[0],
    }
    if device_times:
        (t_enc, _), (t_dec, _) = bench.device_coder_times(
            p.cfg, symbols[: p.n_A], cdf, p.states_A, p.stream_A, reps)
        out["device_encode_Gsym_s"] = p.n_A / t_enc / 1e9
        out["device_decode_Gsym_s"] = p.n_A / t_dec / 1e9
    return out


def sharded_rows(symbols, cdf, cfg, reps):
    import jax

    from constriction_tpu import parallel

    D = len(jax.devices())
    mesh = parallel.make_mesh(D)
    rows = []
    for compact in (False, True):
        cont = parallel.encode(symbols, cdf, cfg=cfg, num_blocks=2 * D,
                               mesh=mesh, compact=compact)
        host = parallel.encode(symbols, cdf, cfg=cfg, num_blocks=2 * D,
                               device=False, compact=compact)
        assert np.array_equal(cont, host), "sharded bytes != host bytes"
        assert np.array_equal(parallel.decode(cont, cdf, mesh=mesh), symbols)
        rows.append({
            "workload": f"sharded container on {D} device(s), "
                        f"{'compact' if compact else 'raw'}",
            "encode_s": common.timed(lambda: parallel.encode(
                symbols, cdf, cfg=cfg, num_blocks=2 * D, mesh=mesh,
                compact=compact), reps)[0],
            "decode_s": common.timed(
                lambda: parallel.decode(cont, cdf, mesh=mesh), reps)[0],
        })
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    dev = common.require_gpu()
    from constriction_tpu.models.categorical import (
        ContiguousCategoricalEntropyModel,
    )
    from constriction_tpu.ops.interleaved import LaneConfig

    print(common.card(), flush=True)
    common.enable_compile_cache()
    rng = np.random.RandomState(args.seed)
    L = common.FLAGSHIP_LANES
    rows = []

    def data(kind, P):
        p = _entropy_model(kind, rng)
        cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
            p, P).cdf
        return rng.choice(K, size=N, p=p).astype(np.int64), p, cdf

    for kind in ("low", "mid", "high"):
        s, p, cdf = data(kind, 12)
        rows.append(row(f"rANS P=12 {kind} entropy", s, p, cdf,
                        LaneConfig(L, 16, 32, 12), args.reps))
    s, p, cdf = data("mid", 24)
    rows.append(row("rANS DEFAULT preset (P=24, W=32, S=64)", s, p, cdf,
                    LaneConfig(L, 32, 64, 24), args.reps))
    rows.append(row("rANS rate-parity config (P=24, L=128)", s, p, cdf,
                    LaneConfig(128, 32, 64, 24), 1, device_times=False))
    rows += sharded_rows(s, cdf, LaneConfig(L, 32, 64, 24), args.reps)
    s, p, cdf = data("low", 24)
    rows.append(row("rANS low entropy, facade's own lanes (P=24)", s, p,
                    cdf, None, args.reps))

    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind},
                      "rows": len(rows)}), flush=True)


if __name__ == "__main__":
    main()
