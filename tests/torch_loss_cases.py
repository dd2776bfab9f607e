"""The shared check of tests/test_torch_loss*.py: one reduced config's
``loss_fn`` and every gradient leaf, the port against the JAX package
(float32, bridged params, the reference's synthetic batch; the MoE through
``gemm_impl="xla_ragged"``, the trainer's).

Tolerances: the loss and float metrics within 1e-5; integer metrics
exact; each gradient leaf within 1e-5 of its largest entry (at least 1) —
zamba2 within 5e-4: its reduced model amplifies float32 rounding
(tests/test_torch_ssm_families.py::test_reduced_zamba2_amplifies_rounding);
rwkv6 within 2e-5: the wkv recurrence sums a gradient such as
``bonus_u``'s over every token in float32, in another order in each
package (8.3e-6 measured).
"""

import jax
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.core.moe_layer import default_runtime as jdefault_runtime
from repro.models import vlm as jvlm
from repro.models.transformer import ParallelCtx
from repro.models.transformer import build_model as jbuild_model
from repro.training.data import synthetic_lm_batches
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.moe_layer import default_runtime
from repro_torch.models.transformer import TrainCtx, build_model
from repro_torch.training import tree

B, L = 2, 16


def check_loss_case(arch, kw, remat, ce_chunk, grid):
    """(arch, config overrides, remat, ce_chunk, image grid or None)."""
    jcfg = jget_config(arch).reduced().replace(dtype="float32", **kw)
    cfg = get_config(arch).reduced().replace(dtype="float32", **kw)
    S = 2 if cfg.moe else 1
    jm = jbuild_model(jcfg, num_servers=S)
    jp = jm.init_params(jax.random.PRNGKey(0))
    jrt = (jdefault_runtime(jcfg, S, B * L, gemm_impl="xla_ragged")
           if jcfg.moe else None)
    batch = next(synthetic_lm_batches(jcfg, B, L, seed=0))
    if grid is not None:
        t0, gh, gw = grid
        batch["mrope_positions"] = jvlm.image_mrope_positions(
            t0, gh, gw, L - t0 - gh * gw)
    ctx = ParallelCtx(remat=remat, moe_runtime=jrt, ce_chunk=ce_chunk)
    (jloss, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss_fn(p, batch, ctx), has_aux=True)(jp)

    model = build_model(cfg, S, None, "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    rt = default_runtime(cfg, S, B * L, "cpu") if cfg.moe else None
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, met = model.loss_fn(params, tbatch,
                              TrainCtx(moe_runtime=rt, remat=remat,
                                       ce_chunk=ce_chunk))
    loss.backward()

    assert abs(loss.item() - float(jloss)) <= 1e-5
    assert set(met) == set(jmet)
    for k, v in jmet.items():
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            np.testing.assert_array_equal(met[k].numpy(), np.asarray(v))
        else:
            np.testing.assert_allclose(met[k].detach().numpy(),
                                       np.asarray(v), atol=1e-5)
    if cfg.moe:
        assert set(met) == {"ce", "aux", "dropped", "miss", "expert_load"}
    tol = {"zamba2-2.7b": 5e-4, "rwkv6-7b": 2e-5}.get(arch, 1e-5)
    jg = jax.tree.map(np.asarray, jg)
    for path, leaf in tree.items(params):
        exp = tree.get(jg, path)
        got = (leaf.grad if leaf.grad is not None
               else torch.zeros_like(leaf)).numpy()
        scale = max(1.0, float(np.abs(exp).max()))
        np.testing.assert_allclose(got, exp, rtol=0, atol=tol * scale,
                                   err_msg=str(path))
