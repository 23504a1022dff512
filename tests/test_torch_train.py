"""Training on one device in the port (``repro_torch.train``, the model's
``loss_fn``, ``init_abstract``, the registry's shapes) on the CPU against
the JAX package, at smoke sizes.

JAX's ``loss_fn`` and ``AdamW`` are called directly (not its ``Trainer``,
to spare its compile time).  Tolerances: gradients within 1e-4 of each
leaf's max |grad| in float32 (the two frameworks sum in other orders); a
train step's parameters within 1e-6 of each leaf's max (the update divides
the gradient by its own size, so the gradients' differences barely reach
it), its moments, linear in the gradients, within 1e-5.  Within the port,
a resumed run and remat are exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import \
    softmax_cross_entropy as j_xent  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro.train.optimizer import cosine_schedule as j_cosine  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config, registry)
from repro_torch.convert import (model_params_from_numpy,  # noqa: E402
                                 model_params_to_numpy,
                                 train_state_from_numpy)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.layers import softmax_cross_entropy  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.train.optimizer import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.trainer import (PreemptionError, Trainer,  # noqa: E402
                                       TrainerConfig)

GRAD_ARCHS = ["llama3-8b", "deepseek-v2-lite-16b", "mamba2-130m",
              "musicgen-medium", "jamba-1.5-large-398b"]


def _pair(arch, **kw):
    """(JAX config, port config, JAX params, port float32 masters)."""
    jc = j_smoke(arch).with_(dtype="float32", **kw)
    tc = ModelConfig(**dataclasses.asdict(jc))
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp), tc, "cpu",
                                 param_dtype=torch.float32)
    return jc, tc, jp, tp


def _batch(cfg, B, S, seed):
    """The same batch for both packages: tokens or (embeds-mode) embeds,
    labels, and a mask with some tokens masked out."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.input_mode == "tokens":
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        b["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                       * 0.02).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _grads(tp, tc, batch):
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    loss, aux = M.loss_fn(tp, tc, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def _leaves_close(got, ref, rel):
    """Per leaf: max |got - ref| <= rel * max |ref|."""
    got, ref = jax.tree.leaves(got), jax.tree.leaves(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= rel * max(np.abs(r).max(), 1e-30)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_equals_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.5).astype(np.float32) if masked else None
    ref = j_xent(jnp.asarray(logits), jnp.asarray(labels),
                 None if mask is None else jnp.asarray(mask))
    got = softmax_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                None if mask is None
                                else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    # an all-zero mask divides by the floor of 1, not by 0
    zero = softmax_cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.zeros((2, 5)))
    assert float(zero) == 0.0


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_gradients_equal_jax(arch):
    """``loss_fn`` and its gradients in float32 against
    ``jax.value_and_grad(repro.models.model.loss_fn)`` from the same
    parameters: llama (GQA), deepseek-v2-lite (MLA, MoE aux loss), mamba2
    (SSD, through ``SSDScan``'s plain stages), musicgen (embeds; its
    unused embedding table gets no gradient in the port, zero in JAX) and
    jamba (attention, MoE and Mamba with two groups in one stack)."""
    jc, tc, jp, tp = _pair(arch)
    jb, tb = _batch(tc, 2, 32, 1)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                             static_argnums=1)(jp, jc, jb)
    loss, aux, grads = _grads(tp, tc, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce_loss"]), float(jaux["ce_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), rtol=1e-4,
                               atol=1e-7)
    if tc.num_experts:
        assert float(aux["moe_aux_loss"]) > 0
    missing = [i for i, g in enumerate(grads) if g is None]
    if tc.input_mode == "embeds":
        assert len(missing) == 1 and not np.asarray(jg["embed"]["w"]).any()
    else:
        assert not missing
    it = iter(grads)
    tg = tree_map(lambda p: (lambda g: torch.zeros_like(p) if g is None
                             else g)(next(it)), tp)
    _leaves_close(model_params_to_numpy(tg, tc), jg, 1e-4)


def test_train_step_equals_jax_update():
    """JAX takes one step (value_and_grad, AdamW.update); its state moves
    to the port by ``train_state_from_numpy``; then both take the second
    step on one batch: parameters within 1e-6 of each leaf's max, moments
    within 1e-5, the loss and learning rate alike."""
    jc, tc, jp, _ = _pair("llama3-8b")
    tcfg = TrainerConfig(seq_len=16, global_batch=2, steps=10, warmup=3,
                         ckpt_every=0)
    jopt = JAdamW(schedule=j_cosine(tcfg.peak_lr, tcfg.warmup, tcfg.steps))
    grad_fn = jax.jit(jax.value_and_grad(JM.loss_fn, has_aux=True),
                      static_argnums=1)
    jb1, _ = _batch(tc, 2, 16, 5)
    jb2, tb2 = _batch(tc, 2, 16, 6)
    js = jopt.init(jp)
    _, g1 = grad_fn(jp, jc, jb1)
    jp, js, _ = jopt.update(g1, js, jp)

    params, opt = train_state_from_numpy(
        jax.tree.map(np.asarray, jp),
        jax.tree.map(np.asarray, js), tc, "cpu")
    assert int(opt.step) == 1
    trainer = Trainer(tc, tcfg, device="cpu")
    params, opt, tm = trainer.train_step(params, opt, tb2)

    (jl, _), g2 = grad_fn(jp, jc, jb2)
    jp, js, jm = jopt.update(g2, js, jp)
    np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=1e-5)
    assert float(tm["lr"]) == float(jm["lr"]) and int(opt.step) == 2
    _leaves_close(model_params_to_numpy(params, tc), jp, 1e-6)
    # the moments are linear in the gradients (mu = 0.9 mu + 0.1 g), so
    # they carry the gradients' own differences (test above: up to ~1e-5
    # of a leaf's max)
    _leaves_close(model_params_to_numpy(opt.mu, tc), js.mu, 1e-5)
    _leaves_close(model_params_to_numpy(opt.nu, tc), js.nu, 1e-5)


def test_grad_accumulation_matches_single_batch(tmp_path):
    """The port of tests/test_infra.py:86."""
    cfg = get_smoke_config("llama3-8b")
    states = []
    for micro in (1, 2):
        tr = Trainer(cfg, TrainerConfig(
            seq_len=32, global_batch=4, steps=1, microbatches=micro,
            ckpt_every=100, ckpt_dir=str(tmp_path / f"m{micro}"),
            log_every=100), device="cpu")
        states.append(tr.run(tr.init_state()))
    for a, b in zip(tree_leaves(states[0].params),
                    tree_leaves(states[1].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3,
                                   rtol=5e-3)
    np.testing.assert_allclose(states[0].metrics["loss_history"],
                               states[1].metrics["loss_history"], rtol=1e-2)


@pytest.mark.parametrize("moment_dtype", ["", "bfloat16"])
def test_preempt_resume_is_bit_identical(tmp_path, moment_dtype):
    """The port of tests/test_infra.py:62, held exactly: a run preempted
    at step 6 and resumed from its step-4 checkpoint ends with the
    uninterrupted run's parameters, moments and loss tail, bit for bit;
    also with bf16 moments, which the checkpoint keeps as bf16."""
    cfg = get_smoke_config("llama3-8b")
    base = dict(seq_len=32, global_batch=2, steps=8, ckpt_every=4,
                log_every=100)

    def trainer(**kw):
        tr = Trainer(cfg, TrainerConfig(**base, **kw), device="cpu")
        if moment_dtype:
            tr.optimizer = dataclasses.replace(tr.optimizer,
                                               moment_dtype=moment_dtype)
        return tr

    t_ref = trainer(ckpt_dir=str(tmp_path / "ref"))
    ref = t_ref.run(t_ref.init_state())
    t1 = trainer(ckpt_dir=str(tmp_path / "run"), preempt_at_step=6)
    with pytest.raises(PreemptionError):
        t1.run(t1.init_state())
    logs = []
    state = trainer(ckpt_dir=str(tmp_path / "run")).run(log=logs.append)
    assert logs[0] == "[trainer] resumed from step 4"
    assert state.step == 8
    assert state.metrics["loss_history"] == ref.metrics["loss_history"][4:]
    for a, b in zip(tree_leaves((state.params, state.opt_state)),
                    tree_leaves((ref.params, ref.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if moment_dtype:
        assert state.opt_state.mu["final_norm"]["scale"].dtype \
            == torch.bfloat16


def test_end_to_end_training_reduces_loss(tmp_path):
    """The port of tests/test_system.py:18."""
    cfg = get_smoke_config("llama3-8b").with_(num_layers=2)
    tr = Trainer(cfg, TrainerConfig(seq_len=64, global_batch=8, steps=40,
                                    ckpt_every=100, ckpt_dir=str(tmp_path),
                                    log_every=100, peak_lr=1e-3, warmup=5),
                 device="cpu")
    hist = tr.run(tr.init_state()).metrics["loss_history"]
    first, last = np.mean(hist[:5]), np.mean(hist[-5:])
    assert last < first * 0.9, (first, last)


def test_end_to_end_train_then_serve(tmp_path):
    """The port of tests/test_system.py:30."""
    cfg = get_smoke_config("llama3-8b")
    tr = Trainer(cfg, TrainerConfig(seq_len=32, global_batch=4, steps=6,
                                    ckpt_every=6, ckpt_dir=str(tmp_path),
                                    log_every=100), device="cpu")
    state = tr.run(tr.init_state())
    wq = state.params["layers"][0]["mixer"]["wq"]
    assert wq.dtype == torch.float32 and not wq.requires_grad
    eng = ServingEngine(cfg, state.params, num_replicas=2, b_slots=2,
                        c_max=48, device="cpu")
    rng = np.random.default_rng(0)
    eng.submit([Request(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                                   size=6).astype(np.int32),
                        max_new=5) for i in range(6)])
    done = eng.run(max_steps=300)
    assert len(done) == 6 and all(len(r.out) == 5 for r in done)


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-lite-16b"])
def test_remat_gives_the_same_gradients(arch):
    """Recomputing each layer in the backward pass (the default, JAX's
    ``nothing_saveable``) changes no gradient bit; ``"dots"`` maps to the
    same."""
    _, tc, _, tp = _pair(arch)
    _, tb = _batch(tc, 2, 16, 2)
    grads = {}
    for remat, policy in ((True, "nothing"), (True, "dots"),
                          (False, "nothing"), (True, "full")):
        grads[remat, policy] = _grads(
            tp, tc.with_(remat=remat, remat_policy=policy), tb)[2]
    ref = grads[False, "nothing"]
    for key, gs in grads.items():
        for a, b in zip(gs, ref):
            assert torch.equal(a, b), key


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_registry_shapes_equal_jax(arch):
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert dataclasses.asdict(registry.get_shape(name)) \
            == dataclasses.asdict(j_registry.get_shape(name))
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert registry.supports_long_context(cfg) \
        == j_registry.supports_long_context(jcfg)
    assert [dataclasses.asdict(s) for s in registry.applicable_shapes(cfg)] \
        == [dataclasses.asdict(s) for s in j_registry.applicable_shapes(jcfg)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_abstract_equals_jax_eval_shape(arch):
    """Every parameter's shape and dtype, and every cache leaf's shape, on
    the meta device: JAX's ``eval_shape`` after the period stacking (and
    the KV cache's (B, C, KV, hd) layout) that ``convert`` undoes."""
    jcfg = j_smoke(arch)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    abstract = M.init_abstract(tcfg)
    assert all(p.device.type == "meta" for p in tree_leaves(abstract))
    ref = JM.init_abstract(jcfg)
    stacked = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
        model_params_to_numpy_shapes(abstract, tcfg))
    assert jax.tree.structure(stacked) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(stacked), jax.tree.leaves(ref)):
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype)

    caches = M.init_cache_abstract(tcfg, 3, 20)
    jcaches = JM.init_cache_abstract(jcfg, 3, 20)
    for l, cache in enumerate(caches):
        jcache = jcaches[f"p{l % tcfg.period}"]
        assert type(cache).__name__ == type(jcache).__name__
        for name, leaf in zip(cache._fields, cache):
            want = tuple(getattr(jcache, name).shape[1:])
            if type(cache).__name__ == "KVCache" and name in ("k", "v"):
                want = (want[0], want[2], want[1], want[3])
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == want, (l, name)


def model_params_to_numpy_shapes(abstract, cfg):
    """``convert.model_params_to_numpy`` for meta tensors: the stacked JAX
    layout of shapes and dtypes."""
    def one(p):
        return jax.ShapeDtypeStruct(tuple(p.shape),
                                    str(p.dtype).removeprefix("torch."))

    def convert(node):
        return {k: convert(v) if isinstance(v, dict) else one(v)
                for k, v in node.items()}

    def stack(nodes):
        return {k: stack([n[k] for n in nodes]) if isinstance(v, dict)
                else jax.ShapeDtypeStruct((len(nodes), *v.shape), v.dtype)
                for k, v in nodes[0].items()}
    out = {k: convert(v) for k, v in abstract.items() if k != "layers"}
    layers = [convert(p) for p in abstract["layers"]]
    out["layers"] = {f"p{p}": stack(layers[p::cfg.period])
                     for p in range(cfg.period)}
    return out


def test_kernels_without_a_backward_refuse_grad():
    """The ssd_scan stage wrappers and decode_attention raise, rather than
    return an output without a gradient, when asked for a graph (meta
    tensors stand in for the card's: the refusal comes before any
    launch); the stage wrappers name ``ssd_scan_cuda`` as the
    differentiable entry."""
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan as sk
    meta = dict(device="meta", requires_grad=True)
    x, b, a = (torch.empty(1, 2, 1, 4, 8, **meta),
               torch.empty(1, 1, 1, 4, 8, **meta),
               torch.empty(1, 2, 1, 4, **meta))
    starts = torch.empty(1, 2, 1, 8, 8, device="meta")
    with pytest.raises(RuntimeError, match="ssd_scan_cuda is the"):
        sk.chunk_states_cuda(x, b, a)
    with pytest.raises(RuntimeError, match="ssd_scan_cuda is the"):
        sk.chunk_scan_cuda(x, b, b, a, starts)
    with pytest.raises(RuntimeError, match="ssd_scan_cuda is the"):
        sk.chunk_dstates_cuda(x, b, a)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention_cuda(torch.empty(1, 2, 16, **meta),
                              torch.empty(1, 1, 8, 16, **meta),
                              torch.empty(1, 1, 8, 16, **meta), 3)
