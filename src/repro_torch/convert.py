"""Carry streams, scan state, results, model parameters, training state
and decode caches (KV, MLA and Mamba, in any mix) between the JAX package
and the port as numpy arrays.

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
from .models.mla import MLACache
from .models.model import layer_descs
from .train.optimizer import AdamWState

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


def _unstack(tree, cfg: ModelConfig, leaf) -> dict:
    """The port's per-layer dictionary from a JAX tree shaped like
    ``init_params``'s: ``leaf(name, array)`` makes each tensor, the layer
    leaves taken from their period's slice."""
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


def model_params_from_numpy(tree, cfg: ModelConfig, device=None,
                            param_dtype: torch.dtype | None = None) -> dict:
    """The port's parameter dictionary from the JAX ``init_params`` pytree as
    numpy (e.g. ``jax.tree.map(np.asarray, params)``).  The JAX layer leaves
    are stacked over periods under ``layers/p{p}``; layer ``l`` is period
    ``l // period`` at position ``p = l % period``.  Norm scales and the
    Mamba parameters the JAX package uses in float32
    (``mamba2.FLOAT32_PARAMS``: ``A_log``, ``D_skip``, ``dt_bias``,
    ``norm_scale``) stay float32; every other leaf is cast to
    ``param_dtype``: ``cfg.dtype`` when None (serving; the cast the JAX
    package applies at use), ``torch.float32`` to keep JAX's masters
    (training)."""
    device = resolve_device(device)
    dt = param_dtype or cdtype(cfg)
    keep = ("scale", *FLOAT32_PARAMS)

    def leaf(name, x):
        x = torch.from_numpy(np.asarray(x, dtype=np.float32).copy())
        return x.to(device=device, dtype=torch.float32 if name in keep
                    else dt)
    return _unstack(tree, cfg, leaf)


def model_params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The JAX ``init_params`` layout as float32 numpy from a tree of the
    port's parameter layout (parameters, gradients, AdamW moments): each
    period position's layers stacked under ``layers/p{p}``."""
    def convert(node):
        return {k: convert(v) if isinstance(v, dict)
                else v.detach().float().cpu().numpy()
                for k, v in node.items()}

    def stack(nodes):
        return {k: stack([n[k] for n in nodes]) if isinstance(v, dict)
                else np.stack([n[k] for n in nodes])
                for k, v in nodes[0].items()}

    out = {name: convert(node) for name, node in params.items()
           if name != "layers"}
    layers = [convert(p) for p in params["layers"]]
    out["layers"] = {f"p{p}": stack(layers[p::cfg.period])
                     for p in range(cfg.period)}
    return out


def train_state_from_numpy(params_tree, adamw_state, cfg: ModelConfig,
                           device=None):
    """``(params, AdamWState)`` for the port's trainer from a JAX
    ``TrainState``'s params and ``AdamWState`` (``step``, ``mu``, ``nu``)
    as numpy: float32 masters, each moment in its own dtype (float32, or
    bfloat16 under ``moment_dtype="bfloat16"``), the step an int32 scalar,
    all on ``device``."""
    device = resolve_device(device)

    def moment(_name, x):
        x = np.asarray(x)
        dt = torch.bfloat16 if str(x.dtype) == "bfloat16" else torch.float32
        return torch.from_numpy(x.astype(np.float32)).to(device=device,
                                                         dtype=dt)

    params = model_params_from_numpy(params_tree, cfg, device,
                                     param_dtype=torch.float32)
    step = torch.tensor(int(np.asarray(adamw_state.step)), dtype=torch.int32,
                        device=device)
    return params, AdamWState(step, _unstack(adamw_state.mu, cfg, moment),
                              _unstack(adamw_state.nu, cfg, moment))


def caches_from_numpy(tree, cfg: ModelConfig, device=None) -> list:
    """The port's per-layer caches from the JAX ``init_cache`` /
    ``decode_step`` caches as numpy (or from :func:`caches_to_numpy`):
    ``{"p{p}": (a, b, length)}`` per period position, the leaves stacked
    over periods, ``length`` (periods,).  By the layer's mixer: a
    ``KVCache`` from k, v (periods, B, C, KV, hd), moved to the kernels'
    (B, KV, C, hd) layout; an ``MLACache`` from c_kv and k_rope (periods,
    B, C, .); a ``MambaCache`` from conv (periods, B, k-1, conv_dim) and
    ssm (periods, B, nh, hd, N), ssm in float32.  Everything else in
    ``cfg.dtype``."""
    device = resolve_device(device)
    dt = cdtype(cfg)
    period = cfg.period
    out = []
    for l, (mixer, _) in enumerate(layer_descs(cfg)):
        a, b, length = tree[f"p{l % period}"]
        i = l // period

        def move(x, dtype=dt):
            x = np.asarray(x, dtype=np.float32)[i]
            if mixer == "attn":
                x = x.transpose(0, 2, 1, 3)
            return torch.from_numpy(x.copy()).to(device=device, dtype=dtype)
        n = torch.tensor(int(np.asarray(length)[i]), dtype=torch.int32,
                         device=device)
        if mixer == "attn":
            out.append(KVCache(move(a), move(b), n))
        elif mixer == "mla":
            out.append(MLACache(move(a), move(b), n))
        else:
            out.append(MambaCache(move(a), move(b, torch.float32), n))
    return out


def caches_to_numpy(caches, cfg: ModelConfig) -> dict:
    """The JAX cache layout as float32 numpy, from the port's caches:
    ``{"p{p}": Cache(a, b (periods, B, ...), length (periods,))}`` with
    each period position's cache type (bfloat16 values are exact in
    float32)."""
    period = cfg.period
    out = {}
    for p in range(period):
        layers = caches[p::period]
        kind = type(layers[0])

        def stack(name):
            x = np.stack([getattr(c, name).detach().float().cpu().numpy()
                          for c in layers])
            return x.transpose(0, 1, 3, 2, 4) if kind is KVCache else x
        out[f"p{p}"] = kind(*(stack(name) for name in kind._fields[:2]),
                            np.array([int(c.length) for c in layers],
                                     dtype=np.int32))
    return out
