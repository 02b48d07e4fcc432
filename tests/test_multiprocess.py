"""Multi-process mesh validation: 2 OS processes x 4 CPU devices, one
global 8-device mesh, cross-process `all_gather` in the decode program.

This replicates the process boundary of a multi-host cluster: unlike the single-process virtual mesh in
the other tests, the collective here crosses jax.distributed's
coordinator-managed process group.
"""

import os
import socket
import subprocess
import sys

import numpy as np  # noqa: F401  (keeps the import graph warm for workers)
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_mp_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_decode():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device counts
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, str(pid), "2"],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=os.path.dirname(HERE),
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and "UNIMPLEMENTED" in out:
            pytest.skip("jax.distributed CPU backend unavailable here")
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"MP_OK pid={pid} devices=8" in out, out[-3000:]
