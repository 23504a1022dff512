"""Carry streams, scan state, results, model parameters, KV caches and Mamba
caches between the JAX package and the port as numpy arrays.

The two packages draw different random numbers from the same seed, so a
parity check generates its inputs once (with either package), hands them
over as numpy, and runs both on the same bits."""
from __future__ import annotations

import numpy as np
import torch

from .core.engine.bfjs import BFJSState
from .core.engine.bfjs_mr import BFJSMRState
from .core.engine.streams import PolicyResult, SchedStreams
from .core.engine.vqs import VQSState
from .core.engine.vqs_bf import VQSBFState
from .device import resolve_device
from .models.attention import KVCache
from .models.config import ModelConfig
from .models.layers import cdtype
from .models.mamba2 import FLOAT32_PARAMS, MambaCache

_STATE_DTYPES = (torch.float32, torch.int32, torch.float32, torch.int32,
                 torch.int32, torch.int32, torch.int32, torch.int32,
                 torch.int32, torch.int32, torch.int32, torch.int32,
                 torch.bool)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def streams_from_numpy(n, sizes, durs, up=None, device=None) -> SchedStreams:
    """``SchedStreams`` on ``device`` from numpy-convertible arrays (e.g.
    ``np.asarray`` of the JAX package's streams), with the port's dtypes:
    int32 counts, float32 sizes, int32 durations, bool fault plane.  A
    leading ensemble axis is kept."""
    device = resolve_device(device)
    return SchedStreams(
        _tensor(n, torch.int32, device), _tensor(sizes, torch.float32, device),
        _tensor(durs, torch.int32, device),
        None if up is None else _tensor(up, torch.bool, device))


def bfjs_state_from_numpy(carry, device=None) -> BFJSState:
    """:class:`BFJSState` from the 13-tuple scan carry of the JAX package's
    ``run_bfjs_streams(..., return_state=True)`` (same field order)."""
    device = resolve_device(device)
    carry = tuple(carry)
    if len(carry) != len(BFJSState._fields):
        raise ValueError(f"expected a {len(BFJSState._fields)}-field carry, "
                         f"got {len(carry)} fields")
    return BFJSState(*(_tensor(x, d, device)
                       for x, d in zip(carry, _STATE_DTYPES)))


#: The boolean fields of the integer carries (VQS family, bfjs-mr); every
#: other field is int32.
_BOOL_FIELDS = ("cfg_k1", "has_cfg", "in_empty", "want", "up_last")


def _state_from_numpy(cls, carry, device):
    """``cls`` (a state NamedTuple whose fields are int32 or bool) from a
    JAX scan carry in the same field order."""
    device = resolve_device(device)
    carry = tuple(carry)
    if len(carry) != len(cls._fields):
        raise ValueError(f"expected a {len(cls._fields)}-field carry, "
                         f"got {len(carry)} fields")
    return cls(*(_tensor(x, torch.bool if f in _BOOL_FIELDS
                         else torch.int32, device)
                 for f, x in zip(cls._fields, carry)))


def vqs_state_from_numpy(carry, device=None) -> VQSState:
    """:class:`VQSState` from the 21-tuple scan carry of the JAX package's
    ``run_vqs_streams(..., return_state=True)`` (same field order)."""
    return _state_from_numpy(VQSState, carry, device)


def vqs_bf_state_from_numpy(carry, device=None) -> VQSBFState:
    """:class:`VQSBFState` from the 23-tuple scan carry of the JAX
    package's ``run_vqs_bf_streams(..., return_state=True)``."""
    return _state_from_numpy(VQSBFState, carry, device)


def bfjs_mr_state_from_numpy(carry, device=None) -> BFJSMRState:
    """:class:`BFJSMRState` from the 18-tuple scan carry of the JAX
    package's ``run_bfjs_mr_streams(..., return_state=True)``."""
    return _state_from_numpy(BFJSMRState, carry, device)


def result_to_numpy(res: PolicyResult) -> PolicyResult:
    """Every tensor field of a result as a numpy array (others unchanged)."""
    return PolicyResult(*(x.detach().cpu().numpy()
                          if isinstance(x, torch.Tensor) else x
                          for x in res))


def model_params_from_numpy(tree, cfg: ModelConfig, device=None) -> dict:
    """The port's parameter dictionary from the JAX ``init_params`` pytree as
    numpy (e.g. ``jax.tree.map(np.asarray, params)``).  The JAX layer leaves
    are stacked over periods under ``layers/p{p}``; layer ``l`` is period
    ``l // period`` at position ``p = l % period``.  Norm scales and the
    Mamba parameters the JAX package uses in float32
    (``mamba2.FLOAT32_PARAMS``: ``A_log``, ``D_skip``, ``dt_bias``,
    ``norm_scale``) stay float32; every other leaf is cast to
    ``cfg.dtype``, the cast the JAX package applies at use."""
    device = resolve_device(device)
    dt = cdtype(cfg)
    keep = ("scale", *FLOAT32_PARAMS)

    def leaf(name, x):
        x = torch.from_numpy(np.asarray(x, dtype=np.float32).copy())
        return x.to(device=device, dtype=torch.float32 if name in keep
                    else dt)

    def convert(node, pick=None):
        return {name: convert(x, pick) if isinstance(x, dict)
                else leaf(name, x if pick is None else np.asarray(x)[pick])
                for name, x in node.items()}

    period = cfg.period
    out = {name: convert(node) for name, node in tree.items()
           if name != "layers"}
    out["layers"] = [convert(tree["layers"][f"p{l % period}"], l // period)
                     for l in range(cfg.num_layers)]
    return out


def kv_caches_from_numpy(tree, cfg: ModelConfig, device=None
                         ) -> list[KVCache]:
    """The port's per-layer caches from the JAX ``init_cache`` /
    ``decode_step`` caches as numpy (or from :func:`kv_caches_to_numpy`):
    ``{"p{p}": (k, v, length)}`` with k, v (periods, B, C, KV, hd) and
    length (periods,).  k and v move to the kernels' (B, KV, C, hd) layout
    in ``cfg.dtype``."""
    device = resolve_device(device)
    dt = cdtype(cfg)
    period = cfg.period
    out = []
    for l in range(cfg.num_layers):
        k, v, length = tree[f"p{l % period}"]
        i = l // period

        def move(x):
            x = np.asarray(x, dtype=np.float32)[i].transpose(0, 2, 1, 3)
            return torch.from_numpy(x.copy()).to(device=device, dtype=dt)
        out.append(KVCache(move(k), move(v), torch.tensor(
            int(np.asarray(length)[i]), dtype=torch.int32, device=device)))
    return out


def kv_caches_to_numpy(caches, cfg: ModelConfig) -> dict:
    """The JAX cache layout as float32 numpy, from the port's caches:
    ``{"p{p}": KVCache(k, v (periods, B, C, KV, hd), length (periods,))}``
    (bfloat16 values are exact in float32)."""
    period = cfg.period
    out = {}
    for p in range(period):
        layers = caches[p::period]
        k, v = (np.stack([getattr(c, name).detach().float().cpu().numpy()
                          .transpose(0, 2, 1, 3) for c in layers])
                for name in ("k", "v"))
        out[f"p{p}"] = KVCache(k, v, np.array([int(c.length) for c in layers],
                                              dtype=np.int32))
    return out


def mamba_caches_from_numpy(tree, cfg: ModelConfig, device=None
                            ) -> list[MambaCache]:
    """The port's per-layer Mamba caches from the JAX ``init_cache`` /
    ``decode_step`` caches of an attention-free stack as numpy (or from
    :func:`mamba_caches_to_numpy`): ``{"p{p}": (conv, ssm, length)}`` with
    conv (periods, B, k-1, conv_dim), ssm (periods, B, nh, hd, N) and
    length (periods,).  conv in ``cfg.dtype``, ssm in float32; the layout
    is the JAX one."""
    device = resolve_device(device)
    period = cfg.period
    out = []
    for l in range(cfg.num_layers):
        conv, ssm, length = tree[f"p{l % period}"]
        i = l // period

        def move(x, dtype):
            x = np.asarray(x, dtype=np.float32)[i]
            return torch.from_numpy(x.copy()).to(device=device, dtype=dtype)
        out.append(MambaCache(move(conv, cdtype(cfg)),
                              move(ssm, torch.float32), torch.tensor(
            int(np.asarray(length)[i]), dtype=torch.int32, device=device)))
    return out


def mamba_caches_to_numpy(caches, cfg: ModelConfig) -> dict:
    """The JAX cache layout as float32 numpy, from the port's Mamba caches:
    ``{"p{p}": MambaCache(conv, ssm (periods, B, ...), length (periods,))}``
    (bfloat16 values are exact in float32)."""
    period = cfg.period
    out = {}
    for p in range(period):
        layers = caches[p::period]
        conv, ssm = (np.stack([getattr(c, name).detach().float().cpu()
                               .numpy() for c in layers])
                     for name in ("conv", "ssm"))
        out[f"p{p}"] = MambaCache(conv, ssm, np.array(
            [int(c.length) for c in layers], dtype=np.int32))
    return out
