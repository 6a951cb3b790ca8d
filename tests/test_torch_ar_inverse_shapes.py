"""The plain masked AR inverse at the shapes the JAX package's flow
options reach (``--hidden``, ``scale_hidden_with_dim=False``,
``pad_dim_multiple``, any ``num_knots``, the 128 dim bucket) and at the
JAX tests' own shapes, against the Pallas kernel in interpret mode: atol
and rtol 1e-5, as ``tests/test_ar_inverse_pallas.py``.  The CUDA kernels
are held against the plain version at these shapes on a card
(``chip_smoke.KERNEL_CASES``, ``tests/test_torch_cuda.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfisam_tpu.flows.ar_inverse_pallas import stack_inverse_masked_pallas
from nfisam_tpu.flows.nsf import NSFConfig as JNSFConfig
from nfisam_tpu.flows.nsf import init_flow_params as j_init_flow_params
from nfisam_tpu_torch.flows import (NSFConfig, flow_params_from_numpy,
                                    stack_inverse_masked_plain)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _carried(jparams):
    return flow_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jparams], "cpu")


# (dim, hidden, knots, flows, sep_dim, circular dims): the JAX tests'
# shapes, the width and bucketing options' shapes, K=20, the 128 bucket
# with a circular dim and pinned columns, and the generic kernel's
# corners (its card cases): d=1, an odd h*d, h and K above its 32 lanes,
# a ring of weight slots, a 2-flow stack and two staged shapes
NEW_SHAPES = [(5, 4, 6, 1, 2, ()), (4, 4, 5, 1, 1, ()), (8, 4, 5, 1, 3, ()),
              (2, 8, 8, 2, 0, ()), (5, 8, 8, 2, 1, ()),
              (16, 16, 9, 1, 2, ()), (16, 4, 9, 1, 2, ()),
              (12, 8, 9, 1, 3, (4,)), (16, 8, 20, 1, 2, (6,)),
              (128, 64, 9, 1, 6, (7, 70)), (1, 3, 2, 1, 0, ()),
              (7, 5, 3, 1, 2, (4,)), (8, 40, 40, 1, 2, (5,)),
              (64, 48, 9, 1, 3, (10,)), (16, 16, 9, 2, 5, (9,)),
              (12, 8, 8, 1, 3, (4,)), (24, 16, 9, 1, 4, (20,))]


@pytest.mark.parametrize("shape", NEW_SHAPES,
                         ids=[f"d{s[0]}h{s[1]}K{s[2]}f{s[3]}"
                              for s in NEW_SHAPES])
def test_plain_inverse_matches_pallas_at_the_new_shapes(shape):
    d, h, K, flows, sep, circular = shape
    n = 40 if d == 128 else 64
    circ = tuple(i in circular for i in range(d)) if circular else ()
    jcfg = JNSFConfig(dim=d, num_knots=K, hidden_dim=h, num_flows=flows,
                      circular=circ)
    cfg = NSFConfig(**dataclasses.asdict(jcfg))
    jparams = j_init_flow_params(jax.random.PRNGKey(d + K), jcfg)
    rng = np.random.default_rng(d * K)
    # biases away from 0, so every layer's bias reaches the numbers
    jparams = [{k: v + (rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
                        if k[0] == "b" else 0.0) for k, v in p.items()}
               for p in jparams]
    z = (rng.normal(size=(n, d)) * 1.5).astype(np.float32)
    mask = np.arange(d) >= sep
    xp = (rng.normal(size=(n, d)) * 0.8).astype(np.float32)
    xp[:, mask] = 0.0
    ref = stack_inverse_masked_pallas(jparams, jnp.asarray(z),
                                      jnp.asarray(xp), jnp.asarray(mask),
                                      jcfg, interpret=True)
    got = stack_inverse_masked_plain(
        _carried(jparams), torch.as_tensor(z), torch.as_tensor(xp),
        torch.as_tensor(mask), cfg).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    np.testing.assert_array_equal(got[:, ~mask], xp[:, ~mask])
