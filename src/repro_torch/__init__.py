"""PyTorch/CUDA port of the cluster-scheduling engines in ``repro``.

The port mirrors ``src/repro``'s layout so each module has an obvious
counterpart.  It imports ``torch`` and numpy only — never ``jax`` and never
the JAX package — and its hot loops are hand-written CUDA kernels for the
H100 (``kernels/csrc``), each with a plain PyTorch version beside it.
The event-driven engine of ``core`` (the paper's schedulers as written,
``simulate`` / ``simulate_trace`` and the stability theory) is host numpy
by design: it is the oracle the accelerated engines are held to.

Entry points run on the card unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
