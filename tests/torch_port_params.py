"""Parameters of the JAX package's models made with numpy from a seed, for
the tests that hold msclip_torch against msclip_tpu.

``jax.eval_shape`` gives the ``init_params`` tree's structure without
running the initializers (which cost tens of seconds on the CPU); every leaf
is then drawn with numpy, off its init value, so that every bias, affine
and BatchNorm statistic is exercised."""

import numpy as np

import jax


def random_jax_params(model, seed=0):
    """A ``msclip_tpu`` params tree (numpy leaves) for ``model.spec``."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", None)
        if name == "var":  # BN running variance: positive
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":  # LN / BN affine scale around 1
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(
                np.float32)
        if name in ("bias", "b", "mean") or leaf.ndim <= 1:
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        # fan-in scaling (convs HWIO, linears [in, out]) keeps the signal
        # of the input alive through the towers
        fan_in = int(np.prod(leaf.shape[:-1]))
        gain = 2.0 if leaf.ndim == 4 else 1.0
        return (np.sqrt(gain / fan_in) * rng.standard_normal(leaf.shape)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)
