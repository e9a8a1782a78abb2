"""The port's training features against the JAX package's, fp32 on the CPU:
GradCache (gradients and BN statistics against ``_gradcache_value_and_grad``
and against the one-shot step), REMAT, DropPath's derived draws, LARC, the
SWA anneal, the SWA BN refresh, the frozen-BN step, the attention calls of
each call pattern, and a toy convergence run.

The tiny MS-CLIP-S geometry and numpy-drawn weights of
``test_torch_train``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from msclip_tpu.models.stem import BNState as JaxBNState
from msclip_tpu.train import averaging as JA
from msclip_tpu.train import optim as JO
from msclip_tpu.train.trainer import _gradcache_value_and_grad
from msclip_tpu.train.trainer import init_train_state as jax_init_state
from msclip_tpu.train.trainer import make_embedding_loss
from msclip_tpu.train.trainer import make_encode_fn as jax_make_encode_fn
from msclip_tpu.train.trainer import make_train_step as jax_make_train_step
from msclip_torch.models import msclip as TM
from msclip_torch.ops import attention as A
from msclip_torch.train import averaging as TA
from msclip_torch.train import optim as TO
from msclip_torch.train import trainer as TT
from msclip_torch.utils.convert import build_key_map, params_from_jax

from test_torch_train import STEPS_PER_EPOCH, _batch, _bn_paths, _jax_leaf
from test_torch_train import tiny  # noqa: F401  (module fixture)
from torch_threads import one_torch_thread  # noqa: F401

GRAD_ATOL = 2e-5  # the JAX package's own GradCache tolerance


def _model(jp, spec):
    return TM.MSClipModel(spec, params_from_jax(jp, spec), trainable=True)


def _grads(model):
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
            for k, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# GradCache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gradcache_jax(tiny):
    """JAX's GradCache loss, BN updates and gradients over 8 pairs in 2 and
    4 microbatches, with training-mode BN and with frozen BN."""
    _, jm, jp, _ = tiny
    images, tokens = _batch(b=8, seed=21)
    out = {}
    for bn in ("training", "frozen"):
        for a in (2, 4):
            vag = jax.jit(_gradcache_value_and_grad(
                jax_make_encode_fn(jm.spec, freeze_bn=bn == "frozen"),
                make_embedding_loss(), a))
            out[bn, a] = vag(jp, jnp.asarray(images), jnp.asarray(tokens),
                             None)
    return images, tokens, out


@pytest.mark.parametrize("accum", [2, 4])
def test_gradcache_gradients_match_jax(tiny, gradcache_jax, accum):
    """Frozen BN, as the JAX package's own GradCache test: every gradient
    within 2e-5."""
    _, _, jp, spec = tiny
    images, tokens, out = gradcache_jax
    (jloss, _), jgrads = out["frozen", accum]
    model = _model(jp, spec)
    loss, _ = TT.gradcache_backward(
        TT.make_encode_fn(spec, freeze_bn=True), model.params(),
        torch.from_numpy(images), torch.from_numpy(tokens), accum)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    n = 0
    for key, got in _grads(model).items():
        want = _jax_leaf(jgrads, spec, key)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_ATOL,
                                   err_msg=key)
        n += 1
    assert n == len(TO.param_labels(model.params(), spec))


@pytest.mark.parametrize("accum", [2, 4])
def test_gradcache_bn_statistics_match_jax(tiny, gradcache_jax, accum):
    """Each microbatch normalizes with its own statistics; the update is
    the mean of the microbatches' recorded running statistics."""
    _, _, jp, spec = tiny
    images, tokens, out = gradcache_jax
    (_, jbn), _ = out["training", accum]
    model = _model(jp, spec)
    _, bn = TT.gradcache_backward(
        TT.make_encode_fn(spec), model.params(), torch.from_numpy(images),
        torch.from_numpy(tokens), accum)
    paths = _bn_paths(spec)
    assert set(bn) == {k for k, v in paths.items() if v in jbn} and bn
    for prefix, (mean, var) in bn.items():
        want = jbn[paths[prefix]]
        np.testing.assert_allclose(mean.numpy(), np.asarray(want["mean"]),
                                   atol=1e-5, err_msg=prefix)
        np.testing.assert_allclose(var.numpy(), np.asarray(want["var"]),
                                   atol=1e-5, err_msg=prefix)


def test_gradcache_step_matches_the_one_shot_step(tiny):
    """Frozen BN: ``ACCUM_STEPS 4`` and the one-shot step give the same
    loss and gradients (2e-5), and the same weights after the step."""
    cfg, _, jp, spec = tiny
    images, tokens = (torch.from_numpy(a) for a in _batch(b=8, seed=5))
    states, metrics = [], []
    for accum in (1, 4):
        state = TT.init_train_state(cfg, spec, params_from_jax(jp, spec),
                                    STEPS_PER_EPOCH, "cpu")
        step = TT.make_train_step(spec, freeze_bn=True, accum_steps=accum)
        metrics.append(step(state, images, tokens))
        states.append(state)
    assert abs(metrics[0]["loss"].item() - metrics[1]["loss"].item()) <= 1e-5
    np.testing.assert_allclose(metrics[1]["grad_norm"].item(),
                               metrics[0]["grad_norm"].item(), rtol=1e-4)
    one, acc = (s.model.params() for s in states)
    for key in one:
        torch.testing.assert_close(acc[key], one[key], atol=GRAD_ATOL,
                                   rtol=0, msg=key)
    for key, (a, b) in {k: (states[0].model.get_parameter(k).grad,
                            states[1].model.get_parameter(k).grad)
                        for k, _ in states[0].model.named_parameters()
                        }.items():
        torch.testing.assert_close(b, a, atol=GRAD_ATOL, rtol=0, msg=key)


def _dropping(spec, **kw):
    return dataclasses.replace(spec, vision_drop_path=0.3, **kw)


def test_gradcache_pass_b_redraws_pass_a(tiny):
    """With drop path on, pass B's embeddings equal pass A's bit for bit:
    both passes draw microbatch ``i``'s masks from the same generator."""
    _, _, jp, spec = tiny
    spec = _dropping(spec)
    images, tokens = (torch.from_numpy(a) for a in _batch(b=8, seed=3))
    encode = TT.make_encode_fn(spec)
    calls = []

    def recording(params, im, tk, generator=None):
        out = encode(params, im, tk, generator)
        calls.append((out[0].detach().clone(), out[1].detach().clone()))
        return out

    model = _model(jp, spec)
    TT.gradcache_backward(
        recording, model.params(), images, tokens, 4,
        generator_of=lambda i: TT.step_generator(0, 3, i, "cpu"))
    assert len(calls) == 8
    for (fa, ta), (fb, tb) in zip(calls[:4], calls[4:]):
        assert torch.equal(fa, fb) and torch.equal(ta, tb)
    # the masks do drop: another step's draws give other embeddings
    other = encode(model.params(), images[:2], tokens[:2],
                   TT.step_generator(0, 4, 0, "cpu"))[0]
    assert not torch.equal(other, calls[0][0])


def test_step_generator_is_a_function_of_its_triple():
    draw = [torch.rand(5, generator=TT.step_generator(*t, "cpu"))
            for t in ((0, 3, 1), (0, 3, 1), (0, 3, 2), (0, 4, 1), (1, 3, 1))]
    assert torch.equal(draw[0], draw[1])
    assert all(not torch.equal(draw[0], d) for d in draw[2:])


def test_remat_gradients_equal_the_plain_ones(tiny):
    """``TPU.REMAT`` with drop path on: the recomputed blocks redraw
    nothing (their masks come in), so loss and gradients are equal."""
    _, _, jp, spec = tiny
    images, tokens = (torch.from_numpy(a) for a in _batch(seed=11))
    out = []
    for remat in (False, True):
        s = _dropping(spec, remat=remat)
        model = _model(jp, s)
        loss, _ = TT.make_loss_fn(s)(model.params(), images, tokens,
                                     TT.step_generator(0, 0, 0, "cpu"))
        loss.backward()
        out.append((loss.item(), _grads(model)))
    assert out[0][0] == out[1][0]
    for key, g in out[0][1].items():
        if key == "token_embedding.weight":
            # the CPU embedding backward sums rows in an order that varies
            # from run to run (two plain runs differ by ~2e-9)
            torch.testing.assert_close(out[1][1][key], g, atol=1e-8, rtol=0)
        else:
            assert torch.equal(out[1][1][key], g), key
    undropped, _ = TT.make_loss_fn(spec)(_model(jp, spec).params(), images,
                                         tokens)
    assert undropped.item() != out[0][0]  # the masks dropped samples


@pytest.mark.parametrize("accum,remat,k1,k2", [
    (1, False, 1, 1), (1, True, 2, 1), (4, False, 2, 1), (2, True, 3, 1)])
def test_attention_calls_of_each_call_pattern(tiny, monkeypatch, accum,
                                              remat, k1, k2):
    """The attention core's forward and backward calls a step, in units
    of one pass through every block (one-shot; REMAT recomputes every
    block in the backward; GradCache runs two forwards a microbatch,
    each of a microbatch's rows): on the card these are K1's and K2's
    launches."""
    cfg, _, jp, spec = tiny
    spec = dataclasses.replace(spec, remat=remat)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = A.attention_qkv_plain, A.attention_qkv_bwd_plain

    def counted(kind, fn):
        def f(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return f

    monkeypatch.setattr(A, "attention_qkv_plain", counted("fwd", fwd))
    monkeypatch.setattr(A, "attention_qkv_bwd_plain", counted("bwd", bwd))
    state = TT.init_train_state(cfg, spec, params_from_jax(jp, spec),
                                STEPS_PER_EPOCH, "cpu")
    images, tokens = (torch.from_numpy(a) for a in _batch(b=8))
    TT.make_train_step(spec, accum_steps=accum)(state, images, tokens)
    blocks = spec.effective_vision_layers - 1 + spec.text_layers
    assert calls == {"fwd": k1 * blocks * accum, "bwd": k2 * blocks * accum}


# ---------------------------------------------------------------------------
# optimizer: LARC, the SWA anneal
# ---------------------------------------------------------------------------

def test_larc_matches_optax(tiny):
    """Four steps of clip -> AdamW (both groups) -> LARC, the same random
    gradients: the weights agree to float rounding, and LARC did clip."""
    cfg, jm, jp, spec = tiny
    cfg = cfg.clone()
    cfg.TRAIN.LARC = True
    cfg.TRAIN.CLIP_GRAD_NORM = 5.0
    tx, _ = JO.build_optimizer(cfg, jp, jm.spec, STEPS_PER_EPOCH)
    jparams = jax.tree.map(jnp.asarray, jp)
    opt_state = tx.init(jparams)

    @jax.jit
    def jax_step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    model = _model(jp, spec)
    named = dict(model.named_parameters())
    optimizer, scheduler = TO.build_optimizer(cfg, model.params(), spec,
                                              STEPS_PER_EPOCH)
    rng = np.random.default_rng(8)
    clipped = 0
    for _ in range(4):
        def draw(path, leaf):
            if getattr(path[-1], "key", None) in ("mean", "var"):
                return np.zeros(leaf.shape, np.float32)
            return (30 * rng.standard_normal(leaf.shape)).astype(np.float32)

        grads = jax.tree_util.tree_map_with_path(draw, jp)
        jparams, opt_state = jax_step(jax.tree.map(jnp.asarray, grads),
                                      opt_state, jparams)
        for key, p in named.items():
            p.grad = _jax_leaf(grads, spec, key)
        norm = TO.global_norm([p.grad for p in named.values()])
        TO.clip_by_global_norm_([p.grad for p in named.values()],
                                cfg.TRAIN.CLIP_GRAD_NORM, norm)
        before = {k: p.detach().clone() for k, p in named.items()}
        TO.larc_step_(optimizer)
        scheduler.step()
        clipped += sum(
            (p.detach() - before[k]).norm().item()
            < 0.999 * 0.02 * before[k].norm().item() for k, p in named.items())
    assert clipped > 0
    for key, p in named.items():
        np.testing.assert_allclose(
            p.detach().numpy(), _jax_leaf(jparams, spec, key).numpy(),
            atol=2e-7, rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("strategy", ["cos", "linear"])
def test_swa_anneal_matches_jax_for_both_groups(tiny, strategy):
    """Step by step, the regular group and the shared one (which anneals
    to ``TRAIN.LR * LR_RATIO`` too, not to the LR_SHARE-scaled value)."""
    cfg = tiny[0].clone()
    cfg.TRAIN.END_EPOCH = 8
    cfg.SWA.ENABLED = True
    cfg.SWA.BEGIN_EPOCH = 3
    cfg.SWA.ANNEAL_EPOCHS = 2
    cfg.SWA.LR_RATIO = 0.3
    cfg.SWA.ANNEAL_STRATEGY = strategy
    spe = 4
    base = JO.build_schedule(cfg, spe)
    scale = cfg.CUSTOM.LR_SHARE / cfg.TRAIN.LR
    want = {"regular": JO.swa_anneal_wrap(base, cfg, spe),
            "shared": JO.swa_anneal_wrap(lambda t: base(t) * scale, cfg, spe)}
    _, _, jp, spec = tiny
    model = _model(jp, spec)
    optimizer, scheduler = TO.build_optimizer(cfg, model.params(), spec, spe)
    for step in range(36):
        for group in optimizer.param_groups:
            label = group["name"].replace("_no_wd", "")
            np.testing.assert_allclose(
                group["lr"], float(want[label](step)), rtol=1e-6,
                atol=1e-7 * cfg.TRAIN.LR, err_msg=f"{group['name']} {step}")
        optimizer.step()
        scheduler.step()
    assert optimizer.param_groups[0]["lr"] == pytest.approx(
        cfg.TRAIN.LR * 0.3)


# ---------------------------------------------------------------------------
# averaging and frozen BN
# ---------------------------------------------------------------------------

def test_ema_and_swa_updates():
    a = {"x": torch.tensor([1.0, 2.0])}
    p = {"x": torch.tensor([3.0, 6.0])}
    TA.ema_update(a, p, 0.75)
    torch.testing.assert_close(a["x"], torch.tensor([1.5, 3.0]))
    s = {"x": torch.tensor([1.0, 1.0])}
    n = TA.swa_update(s, p, 1)
    assert n == 2
    torch.testing.assert_close(s["x"], torch.tensor([2.0, 3.5]))


def test_swa_refresh_bn_matches_jax(tiny):
    """Three batches at momenta 1, 1/2, 1/3: the cumulative average of the
    batch statistics, as ``torch.optim.swa_utils.update_bn``."""
    _, jm, jp, spec = tiny
    batches = [_batch(seed=30 + k)[0] for k in range(3)]
    want = JA.swa_refresh_bn(jax.tree.map(jnp.asarray, jp), jm.spec,
                             batches)
    params = params_from_jax(jp, spec)
    got = TA.swa_refresh_bn(params, spec,
                            (torch.from_numpy(b) for b in batches))
    assert got is params
    n = 0
    for key in params:
        if key.endswith((".running_mean", ".running_var")):
            np.testing.assert_allclose(
                got[key].numpy(), _jax_leaf(want, spec, key).numpy(),
                atol=1e-5, rtol=1e-4, err_msg=key)
            n += 1
    assert n > 20


def test_bn_state_momentum_blends_the_running_stats(tiny):
    _, _, jp, spec = tiny
    params = params_from_jax(jp, spec)
    images = torch.from_numpy(_batch()[0])
    out = {}
    for m in (0.1, 0.5):
        bn = TM.S.BNState(training=True, momentum=m)
        TM.encode_image(params, spec, images, bn=bn)
        out[m] = bn.updates
    key = next(iter(out[0.1]))
    old = params[f"{key}.running_mean"]
    batch_mean = (out[0.5][key][0] - 0.5 * old) / 0.5
    torch.testing.assert_close(out[0.1][key][0], 0.9 * old + 0.1 * batch_mean)
    assert JaxBNState().momentum == TM.S.BNState().momentum == 0.1


def test_frozen_bn_step_matches_jax(tiny):
    """``SWA.FROZEN_BN``: BN in eval mode inside the step, no update
    recorded; loss, weights and running statistics as the JAX step's."""
    cfg, jm, jp, spec = tiny
    tx, _ = JO.build_optimizer(cfg, jp, jm.spec, STEPS_PER_EPOCH)
    jstate = jax_init_state(jm, tx, params=jax.tree.map(jnp.asarray, jp))
    jstep = jax_make_train_step(jm.spec, tx, freeze_bn=True, donate=False)
    state = TT.init_train_state(cfg, spec, params_from_jax(jp, spec),
                                STEPS_PER_EPOCH, "cpu")
    step = TT.make_train_step(spec, freeze_bn=True)
    before = {k: v.clone() for k, v in state.model.params().items()
              if TM.is_bn_stat(k)}
    for i in range(2):
        images, tokens = _batch(seed=40 + i)
        jstate, jmet = jstep(jstate, jnp.asarray(images), jnp.asarray(tokens))
        metrics = step(state, torch.from_numpy(images),
                       torch.from_numpy(tokens))
        assert abs(metrics["loss"].item() - float(jmet["loss"])) <= 1e-5
    now = state.model.params()
    assert all(torch.equal(now[k], v) for k, v in before.items())
    stored, _ = build_key_map(spec)
    for key in stored:
        np.testing.assert_allclose(
            now[key].detach().numpy(),
            _jax_leaf(jstate.params, spec, key).numpy(), atol=1e-5,
            err_msg=key)


# ---------------------------------------------------------------------------
# convergence (tests/test_convergence.py for the port)
# ---------------------------------------------------------------------------

N_CLASSES = 8


def test_toy_training_reaches_perfect_retrieval(tiny):
    """The real train step (param groups, weight-decay mask, timm
    schedule, BN threading, InfoNCE) from the port's own init learns 8
    image prototypes <-> 8 captions from noisy views to perfect in-batch
    retrieval: a sign error in one tower's gradient, or a schedule that
    stalls, would not."""
    cfg, _, _, spec = tiny
    cfg = cfg.clone()
    cfg.TRAIN.LR = 1e-2
    steps = 100
    state = TT.init_train_state(
        cfg, spec, TM.init_params(spec, torch.Generator().manual_seed(0)),
        steps // cfg.TRAIN.END_EPOCH, "cpu")
    step = TT.make_train_step(spec)
    rng = np.random.default_rng(0)
    protos = rng.standard_normal(
        (N_CLASSES, spec.image_resolution, spec.image_resolution, 3)
    ).astype(np.float32)
    tokens = np.zeros((N_CLASSES, spec.context_length), np.int32)
    tokens[:, 0] = spec.vocab_size - 2
    tokens[:, 1:5] = rng.integers(1, spec.vocab_size - 2, (N_CLASSES, 4))
    tokens[:, 5] = spec.vocab_size - 1
    tokens = torch.from_numpy(tokens)
    noise = np.random.default_rng(1)

    def noisy():
        return torch.from_numpy(protos + 0.05 * noise.standard_normal(
            protos.shape).astype(np.float32))

    losses = [step(state, noisy(), tokens)["loss"].item()
              for _ in range(steps)]
    with torch.no_grad():
        params = state.model.params()
        fi = TM.encode_image(params, spec, noisy())
        ft = TM.encode_text(params, spec, tokens)
    top1 = (fi @ ft.t()).argmax(dim=1).eq(torch.arange(N_CLASSES))
    assert losses[0] > 0.5 * np.log(N_CLASSES)
    assert np.mean(losses[-10:]) < 0.15, losses[-10:]
    assert top1.all(), top1
