"""The port's logical sharding resolver against the JAX package's, on the
cases of ``tests/test_sharding.py`` (meshes given by axis names and sizes),
and its one-device ``ShardingCtx``."""

import numpy as np
import pytest
import jax
import torch

from repro.sharding import LogicalRules as JaxRules
from repro.sharding import resolve_spec as jax_resolve
from repro_torch.sharding import LogicalRules, Mesh, ShardingCtx, resolve_spec

RULES = LogicalRules.default()


def _jax_mesh(shape, axes):
    devs = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return jax.sharding.Mesh(devs, axes)


def _both(names, dims, shape, axes, overrides=None) -> tuple:
    """The port's spec, after checking it equals JAX's entry by entry."""
    rules, jrules = RULES, JaxRules.default()
    if overrides:
        rules, jrules = rules.override(**overrides), jrules.override(**overrides)
    got = resolve_spec(names, dims, Mesh(axes, shape), rules)
    want = tuple(jax_resolve(names, dims, _jax_mesh(shape, axes), jrules))
    assert got == want, (got, want)
    return got


def test_basic_param_spec():
    assert _both(("embed", "mlp"), (512, 2048), (4, 2),
                 ("data", "model")) == ("data", "model")


def test_multi_axis_batch_group():
    assert _both(("act_batch", "act_seq", "act_embed"), (64, 128, 256),
                 (2, 4, 2), ("pod", "data", "model")) == \
        (("pod", "data"), None, None)


def test_missing_axis_dropped():
    assert _both(("act_batch", None), (64, 128), (4, 2),
                 ("data", "model")) == ("data", None)


def test_indivisible_falls_back_to_replicated():
    # 24 heads (minitron) % 16 != 0 -> replicated; head_dim picks up model
    assert _both(("heads", "head_dim"), (24, 128), (2, 16),
                 ("data", "model")) == (None, "model")


def test_axis_not_reused_within_tensor():
    assert _both(("experts", "embed", "expert_mlp"), (8, 512, 1024), (2, 4),
                 ("data", "model")) == ("model", "data", None)


def test_kv_fallback_chain_for_decode_cache():
    names = ("act_batch", "act_kv", "act_kv_seq", "act_head_dim")
    assert _both(names, (128, 8, 32768, 128), (4, 16),
                 ("data", "model")) == ("data", None, "model", None)
    assert _both(names, (128, 16, 32768, 128), (4, 16),
                 ("data", "model")) == ("data", "model", None, None)


def test_override():
    assert _both(("act_batch", "act_seq", "act_embed"), (32, 1024, 512),
                 (4, 2), ("data", "model"),
                 overrides={"act_seq": ["model"]}) == ("data", "model", None)


def test_size_one_axis_never_assigned():
    assert _both(("act_batch", "act_heads"), (7, 16), (1, 2),
                 ("data", "model")) == (None, "model")


def test_names_and_shape_must_agree():
    with pytest.raises(ValueError):
        resolve_spec(("act_batch",), (4, 4), Mesh.local(), RULES)


def test_one_device_ctx_is_the_identity_and_exposes_the_mesh():
    sctx = ShardingCtx.local()
    assert sctx.mesh.axis_names == ("data", "model")
    assert sctx.mesh.axis_sizes == {"data": 1, "model": 1}
    x = torch.ones(2, 3, 4)
    assert sctx.constrain(x, ("act_batch", "act_res_seq", None)) is x
    with pytest.raises(ValueError):
        sctx.constrain(x, ("act_batch", None))


def test_multi_device_ctx_refuses_to_place():
    sctx = ShardingCtx(Mesh(("data", "model"), (2, 2)), RULES)
    assert sctx.spec(("act_batch", "act_heads"), (4, 8)) == ("data", "model")
    # names and sizes only: no ranks behind the mesh to place on
    with pytest.raises(ValueError, match="no ranks behind it"):
        sctx.constrain(torch.ones(4, 8), ("act_batch", "act_heads"))
