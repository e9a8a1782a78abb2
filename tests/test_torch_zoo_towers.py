"""Every model-zoo family's whole towers in the port against the JAX
package's, fp32 on the CPU, on the same numpy weights
(``torch_zoo_configs``): eval BatchNorm, BN-folded eval (where the JAX
package folds), and training BatchNorm with its recorded running
statistics."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msclip_tpu.models.folding import fold_params_for_eval as jax_fold
from msclip_tpu.models.stem import BNState as JaxBN
from msclip_torch.models import msclip as TM
from msclip_torch.models.folding import fold_params_for_eval
from msclip_torch.models.stem import BNState
from msclip_torch.utils.convert import build_key_map

from torch_threads import one_torch_thread  # noqa: F401
from torch_zoo_configs import FAMILIES, action, build, family_config, inputs

# fp32 through 6 blocks and the conv branch, sums in another order than
# XLA's (the MS-CLIP-S towers' bound, tests/test_torch_model.py)
ATOL = 1e-4
# the training BatchNorms' running statistics (tests/test_torch_train.py)
BN_RTOL, BN_ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _built(name):
    return build(family_config(name))


def _action_kw(spec):
    if not spec.ext.gumbel_select:
        return {}, {}
    a = action(spec.vision_layers)
    return {"action": jnp.asarray(a)}, {"action": torch.from_numpy(a)}


def _bn_paths(spec):
    """Reference BN prefix -> the JAX package's BNState update path (which
    names CvT's inner convs ``cvt_q``, not their ``cvt_inside/q`` tree)."""
    stored, _ = build_key_map(spec)
    out = {}
    for k in stored:
        if k.endswith(".running_mean"):
            path = "/".join(str(p) for p in stored[k][0][:-1])
            out[k[:-len(".running_mean")]] = path.replace(
                "cvt_inside/", "cvt_")
    return out


@pytest.mark.parametrize("mode", ["eval", "folded"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_towers_match_jax(name, mode):
    jm, jp, spec, tp = _built(name)
    if mode == "folded":
        jp = jax.jit(lambda p: jax_fold(p, jm.spec))(jp)
        tp = fold_params_for_eval(tp, spec)
        folds = not (spec.t2b_bn_relu or spec.t2b_bn_ln_relu
                     or spec.parallel_b2t)
        assert (set(tp) != set(_built(name)[3])) == folds
    images, tokens = inputs()
    kw_j, kw_t = _action_kw(spec)
    want_i = jax.jit(lambda p, x: jm.encode_image(p, x, **kw_j))(
        jp, jnp.asarray(images))
    want_t = jax.jit(lambda p, x: jm.encode_text(p, x, **kw_j))(
        jp, jnp.asarray(tokens))
    got_i = TM.encode_image(tp, spec, torch.from_numpy(images), **kw_t)
    got_t = TM.encode_text(tp, spec, torch.from_numpy(tokens), **kw_t)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=ATOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=ATOL)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_image_tower_trains_batch_norm_as_jax(name):
    """Training BatchNorm: the features and every recorded running
    statistic, the stem's, the branch's, the adapters' and the
    families' own convs'."""
    jm, jp, spec, tp = _built(name)
    images, _ = inputs()
    kw_j, kw_t = _action_kw(spec)

    def jax_fn(p, x):
        bn = JaxBN(training=True)
        return jm.encode_image(p, x, bn=bn, **kw_j), bn.updates

    want, jupd = jax.jit(jax_fn)(jp, jnp.asarray(images))
    bn = BNState(training=True)
    got = TM.encode_image(tp, spec, torch.from_numpy(images), bn=bn, **kw_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    paths = _bn_paths(spec)
    assert set(bn.updates) <= set(paths) and len(bn.updates) == len(jupd)
    for prefix, (mean, var) in bn.updates.items():
        ref = jupd[paths[prefix]]
        for got_s, want_s in ((mean, ref["mean"]), (var, ref["var"])):
            np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                       rtol=BN_RTOL, atol=BN_ATOL,
                                       err_msg=prefix)
