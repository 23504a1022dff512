"""Ensemble Monte-Carlo over devices and chunks (torch counterpart of
``repro.core.engine.sharding``).

The paper's headline evidence averages over large ensembles of
independently simulated clusters — embarrassingly parallel in the
ensemble dimension G.  This module splits G over a 1-D "mesh": a tuple of
``torch.device`` (axis name :data:`ENSEMBLE_AXIS`).  The member list is
cut into D contiguous equal shards; shard d runs the unmodified policy
Monte-Carlo (``get_policy(policy).monte_carlo``) on ``mesh[d]``, and the
results are concatenated, in member order, on ``mesh[0]``.  No collectives
are needed, and time never crosses devices.

Every member draws its streams from its own generator seeded with its own
seed (``bfjs.ensemble_streams``), and no engine mixes members, so a
sharded run is BIT-IDENTICAL to the unsharded run on the same device type,
for every policy and engine.  ``engine="reference"`` (the host oracles)
ignores the mesh, as in the JAX package.

Shards on distinct devices are issued from one host thread per device, so
that a policy path that synchronises its device (a result read back to the
host) does not hold the other cards; shards that share a device run one
after the other on the calling thread.

Unlike a JAX mesh, a device list may name the same device more than once
(``devices=["cpu"] * 4``, ``devices=[card, card]``): the CPU has one torch
device, and a one-card machine one card, so that is how the split and the
merge are exercised there.  Each repeated entry is one shard.

:func:`monte_carlo_chunked` composes the mesh with
``core.engine.chunked``: each chunk's carry is split over the mesh and
gathered back before the checkpoint, which names no device count, so a
sweep checkpointed on D shards resumes bit-exactly on D'.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Callable, Sequence

import torch

from ...device import resolve_device
from .bfjs import ensemble_streams
from .streams import PolicyResult

#: The name of the one mesh axis the ensemble dimension is split over.
ENSEMBLE_AXIS = "ensemble"

Mesh = tuple  # a 1-D mesh: a tuple of torch.device, one per shard


def resolve_mesh(mesh: Sequence | None = None,
                 devices: int | Sequence | None = None) -> Mesh | None:
    """Normalise the ``mesh=`` / ``devices=`` knobs to a 1-D mesh (a tuple
    of ``torch.device``), or None.

    ``devices=`` is the convenience form: an int takes the first N of
    ``torch.cuda.device_count()`` cards; a sequence of devices (or device
    strings) is used as given, repeats included.  ``mesh=`` takes the same
    sequences and must be 1-D.  Both None means unsharded."""
    if mesh is not None and devices is not None:
        raise ValueError("pass mesh= or devices=, not both")
    if mesh is not None:
        devs = list(mesh)
        if any(isinstance(d, (list, tuple)) for d in devs):
            raise ValueError(
                "ensemble sharding needs a 1-D mesh (a flat device list); "
                "only the ensemble dimension G is split, time windows stay "
                "on their device")
        return _as_mesh(devs)
    if devices is None:
        return None
    if isinstance(devices, int):
        avail = torch.cuda.device_count()
        if devices < 1 or devices > avail:
            raise ValueError(
                f"devices={devices} but {avail} CUDA device(s) are visible; "
                "pass a device list to place several shards on one device "
                f"(devices=[\"cuda:0\"] * {devices}, or [\"cpu\"] * "
                f"{devices} on the CPU)")
        return tuple(torch.device("cuda", i) for i in range(devices))
    return _as_mesh(list(devices))


def _as_mesh(devs: list) -> Mesh:
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return tuple(torch.device(d) for d in devs)


def _check_divides(G: int, mesh: Mesh) -> None:
    ndev = len(mesh)
    if G % ndev:
        raise ValueError(
            f"ensemble size G={G} must divide evenly over the {ndev}-device "
            f"mesh (equal per-device shards); pad the seed list or change "
            "the device count")


def run_shards(fn: Callable, mesh: Mesh, items: Sequence) -> list:
    """``[fn(items[d], mesh[d]) for d in range(len(mesh))]``, with the
    shards of distinct devices issued from one host thread per device (on
    that device's current-device context) and the shards of one device in
    order.  The first exception raised by any shard propagates."""
    order: dict[torch.device, list[int]] = {}
    for d, dev in enumerate(mesh):
        order.setdefault(dev, []).append(d)
    out: list = [None] * len(mesh)

    def run_device(dev):
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()
        with ctx:
            for d in order[dev]:
                out[d] = fn(items[d], dev)

    if len(order) == 1:
        run_device(mesh[0])
        return out
    with ThreadPoolExecutor(max_workers=len(order)) as pool:
        for f in [pool.submit(run_device, dev) for dev in order]:
            f.result()
    return out


def gather(parts: Sequence, device) -> tuple:
    """Concatenate NamedTuples of ``(G_d, ...)`` tensors along the member
    axis on ``device`` (None leaves stay None)."""
    fields = []
    for leaves in zip(*parts):
        if leaves[0] is None:
            fields.append(None)
        else:
            fields.append(torch.cat([x.to(device) for x in leaves]))
    return type(parts[0])(*fields)


def split(tree, mesh: Mesh) -> list:
    """Cut a NamedTuple of ``(G, ...)`` tensors into ``len(mesh)``
    contiguous member shards, shard d moved to ``mesh[d]``."""
    ndev = len(mesh)
    G = next(x for x in tree if x is not None).shape[0]
    _check_divides(G, mesh)
    per = G // ndev
    return [type(tree)(*(None if x is None else
                         x[d * per:(d + 1) * per].to(mesh[d])
                         for x in tree)) for d in range(ndev)]


def sharded_monte_carlo(workload, seeds, *, policy: str = "bfjs",
                        mesh: Mesh, engine: str = "scan",
                        **config) -> PolicyResult:
    """Run a registered policy's Monte-Carlo with G split over ``mesh``.

    Shard d runs ``get_policy(policy).monte_carlo`` on its G/D seeds on
    ``mesh[d]`` (any ``device=`` in ``config`` is replaced by the mesh);
    the result is one ``(G, ...)`` PolicyResult on ``mesh[0]``, equal to
    the unsharded run.  ``engine="reference"`` ignores the mesh."""
    from .api import get_policy

    spec = get_policy(policy)
    if engine == "reference":
        return spec.monte_carlo(workload, seeds, engine=engine, **config)
    seeds = [int(s) for s in seeds]
    _check_divides(len(seeds), mesh)
    config.pop("device", None)
    per = len(seeds) // len(mesh)
    shards = [seeds[d * per:(d + 1) * per] for d in range(len(mesh))]
    parts = run_shards(
        lambda s, dev: spec.monte_carlo(workload, s, engine=engine,
                                        device=dev, **config),
        mesh, shards)
    return gather(parts, mesh[0])


def monte_carlo_chunked(workload, seeds, *, policy: str = "bfjs",
                        chunk: int, mesh: Mesh | None = None,
                        checkpoint_dir: str | None = None,
                        resume: bool = False,
                        stop_after_chunks: int | None = None,
                        horizon: int = 10_000, fault_rate: float = 0.0,
                        repair_rate: float = 1.0, device=None,
                        **config) -> PolicyResult:
    """Crash-safe chunked Monte-Carlo: one member per integer seed,
    optionally split over ``mesh``.

    Generates the whole ensemble's streams on ``device`` (default: the
    card; with a mesh, on ``mesh[0]``), member g equal to the straight
    Monte-Carlo path's member g, then runs
    :func:`~repro_torch.core.engine.chunked.run_chunked` over them, every
    member batched in each chunk and, with ``mesh=``, each chunk's members
    split over the mesh.  Checkpoints store the full ``(G, ...)`` carry
    host-side and name no device, so ``resume=True`` continues on any mesh
    whose size divides G."""
    if policy != "bfjs-mr":
        workload.require_scalar(policy)
    workload.check_sampler()
    seeds = [int(s) for s in seeds]
    if mesh is not None:
        _check_divides(len(seeds), mesh)
        device = mesh[0]
    streams = ensemble_streams(
        seeds, workload.lam, workload.mu, workload.sampler,
        L=config.get("L", 8), K=config.get("K", 16),
        A_max=config.get("A_max", 8), horizon=horizon,
        device=resolve_device(device),
        num_resources=workload.num_resources, fault_rate=fault_rate,
        repair_rate=repair_rate)
    if policy == "bfjs-mr" and "capacity" not in config:
        config["capacity"] = workload.capacity
    from .chunked import run_chunked
    return run_chunked(streams, policy=policy, chunk=chunk, mesh=mesh,
                       checkpoint_dir=checkpoint_dir, resume=resume,
                       stop_after_chunks=stop_after_chunks, **config)
