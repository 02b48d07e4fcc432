"""The one place that decides how the device coder runs.

:func:`coder_route` names the implementation behind the ILANS2 device
encode and decode (ops/device_coder.py):

- ``"cuda"`` on an NVIDIA GPU: the hand-written Hopper kernels in
  ``constriction_tpu/cuda`` (built with nvcc at first use);
- ``"xla"`` on the CPU: the plain ``lax.scan`` coder in ops/jax_coder2.py,
  which is what the tests exercise.

Any other platform is an error: nothing falls back to an interpreter or
to the host oracle behind the caller's back.  :func:`forced` pins a route
inside a ``with`` block, so that a benchmark can time both on one card.
"""

from __future__ import annotations

import contextlib

import jax

ROUTES = ("cuda", "xla")

_forced: str | None = None


def platform() -> str:
    """The default device's platform, ``"gpu"`` or ``"cpu"``."""
    p = jax.devices()[0].platform
    if p in ("gpu", "cuda"):
        return "gpu"
    if p == "cpu":
        return "cpu"
    raise RuntimeError(
        f"no device route for platform {p!r}: constriction_tpu runs its "
        "device coders on an NVIDIA GPU or, for tests, on the CPU"
    )


def on_accelerator() -> bool:
    """True when the default device is a GPU (device routes are the
    default there; on the CPU the host coders are)."""
    return platform() == "gpu"


def coder_route() -> str:
    """``"cuda"`` or ``"xla"`` for the ILANS2 device coder."""
    if _forced is not None:
        return _forced
    return "cuda" if platform() == "gpu" else "xla"


@contextlib.contextmanager
def forced(route: str):
    """Run the device coder through ``route`` inside the block.  ``"cuda"``
    needs a GPU."""
    global _forced
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "cuda" and platform() != "gpu":
        raise RuntimeError("the cuda route needs a GPU")
    prev, _forced = _forced, route
    try:
        yield
    finally:
        _forced = prev
