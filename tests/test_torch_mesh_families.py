"""The dry-run cells of gemma3, whisper, zamba2 and rwkv6 on 8 gloo ranks
of a (2, 4) mesh against the JAX package's ``build_cell`` on 8 host
devices (``tests/torch_mesh_family_cases.py``).

Per family, three cells, each as ``test_torch_mesh_cells.py`` holds the
decoder family's:

* train (phase ``train_tp``: all four are under 17 B params): one
  Adafactor step; the loss, the grad norm and every updated shard;
* prefill (phase ``serve``): each rank's rows of the last-position
  logits and its block of the cache, placed by role
  (``sharding_rules.cache_placements``);
* decode (phase ``decode``, the linear caches slot-sharded over
  ``model``): the rows of the logits and of the next token, and the
  cache shard after the step.

The configs exercise what production does: gemma3 with a global group
and a ring (16 slots) shorter than the cells' 48 (the ring stays whole on
every rank and wraps in the decode cell); whisper with 2 heads, which do
not split whole over 4 model ranks (the cross-attention's heads
gathered); zamba2's ``in_proj`` cut across its segments (552 columns over
4); rwkv6's whole model through its island, the time-mix ``w_v`` cut
as the island takes it (column-parallel) when sharded.  Tolerance 1e-5 (float32); zamba2's 5e-4 is its
recorded amplification (``test_torch_ssm_families.py::
test_reduced_zamba2_amplifies_rounding``).  The train cells are held
elementwise.  The serving cells' logits and cache leaves are held
normwise: each array within the tolerance times its largest magnitude
(at least 1).  The recurrent states hold sums over the sequence (rwkv6's
wkv entries run to ~20 after 48 tokens), and a deep layer's keys and
values carry the amplified rounding of the layers below: elementwise,
a small entry of such an array would have to round more finely than
the float32 spacing of the terms it sums.
"""

import numpy as np
import pytest

import torch_mesh_family_cases as fc
from repro_torch.distributed import sharding_rules as tsr

F32 = dict(rtol=1e-5, atol=1e-5)
TOL = {"g3": F32, "wh": F32, "rw": F32, "z2": dict(rtol=5e-4, atol=5e-4)}


def _close(got, want, tol, what):
    """Normwise: ``max |got - want| <= tol * max(1, max |want|)``."""
    bound = tol["atol"] * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert got.shape == want.shape, what
    assert err <= bound, f"{what}: max |err| {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return fc.run(tmp_path_factory.mktemp("families"), list(fc.FAMILIES))


@pytest.mark.parametrize("family", list(fc.FAMILIES))
def test_train_cell_matches_reference(runs, family):
    """One train step: the metrics on every rank and each rank's updated
    shards equal the reference's (its whole params, cut by the table)."""
    _, ref, ranks = runs
    key, tol = f"cell/{family}_train", TOL[family]
    for r in ranks:
        assert str(r[key + "/phase"]) == "train_tp"
        for k in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(r[f"{key}/{k}"], ref[f"{key}/{k}"],
                                       **tol, err_msg=k)
    whole = fc.unflat(ref, key + "/p/")
    n = 0
    for d in range(2):
        for m in range(4):
            want = fc.flat(tsr.shard_params(whole, fc.Coord(d, m),
                                            "train_tp", dense=True))
            got = fc.flat(fc.unflat(ranks[d * 4 + m], key + "/p/"))
            assert set(got) == set(want)
            for path, w in want.items():
                np.testing.assert_allclose(got[path], w, **tol,
                                           err_msg=f"{path} @ {d}{m}")
                n += 1
    assert n > 8 * 8


@pytest.mark.parametrize("family", list(fc.FAMILIES))
def test_prefill_cell_matches_reference(runs, family):
    """The prefill cell (phase ``serve``): each rank's rows of the
    last-position logits and its block of the cache."""
    _, ref, ranks = runs
    key, tol = f"cell/{family}_prefill", TOL[family]
    specs = fc.cache_specs(family, ())
    b = fc.B // 2
    for rank, r in enumerate(ranks):
        d, m = divmod(rank, 4)
        assert str(r[key + "/phase"]) == "serve"
        _close(r[key + "/logits"], ref[key + "/logits"][d * b:(d + 1) * b],
               tol, f"logits @ {d}{m}")
        for path, (spec, shape) in specs.items():
            _close(r[f"{key}/{path}"],
                   fc.rank_shard(ref[f"{key}/{path}"], spec, shape, d, m),
                   tol, f"{path} @ {d}{m}")


@pytest.mark.parametrize("family", list(fc.FAMILIES))
def test_decode_cell_matches_reference(runs, family):
    """The serve step (phase ``decode``): each rank's rows of the logits
    and next token, and its shard of the cache after the step (a linear
    cache's new token written by its slot's owner only)."""
    _, ref, ranks = runs
    key, tol = f"cell/{family}_decode", TOL[family]
    specs = fc.cache_specs(family, ("model",))
    b = fc.B // 2
    for rank, r in enumerate(ranks):
        d, m = divmod(rank, 4)
        assert str(r[key + "/phase"]) == "decode"
        rows = slice(d * b, (d + 1) * b)
        _close(r[key + "/logits"], ref[key + "/logits"][rows], tol,
               f"logits @ {d}{m}")
        np.testing.assert_array_equal(r[key + "/next"],
                                      ref[key + "/next"][rows])
        for path, (spec, shape) in specs.items():
            _close(r[f"{key}/{path}"],
                   fc.rank_shard(ref[f"{key}/{path}"], spec, shape, d, m),
                   tol, f"{path} @ {d}{m}")
