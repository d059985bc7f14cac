"""The port's other LM families (moe, vlm, hybrid, ssm, encdec) against
the JAX package, on the CPU, at each config's ``smoke()`` width: the
configs, the specs and the parameters here; forward, bf16, list-form,
decode and serving parity in ``test_torch_families_*.py``.

The same inputs, made from a seed with numpy, go through the JAX
``Model`` and the port's.  Weights cross over as numpy arrays
(``convert.lm_params_from_numpy``), so the forward comparisons see equal
weights.  Tolerances of all these files, each with its reason:

* the initial weights: 1e-6 (``random.normal`` is within 7.15e-7);
* float32 logits: 1e-4, matrix products, cumulative sums and scans
  summed in another order; the hybrid's 5e-4 (``logit_tol``: its SSD
  chunks' float32 spread);
* float32 loss: 1e-5, the mean of the log-softmax of those logits;
* bfloat16 loss: 2e-2, the two frameworks round bf16 at other places;
* the numpy round trip and the configs: equal, exactly."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_config as jget_config
from repro.configs.base import LM_SHAPES as JLM_SHAPES
from repro.models import Model as JModel
from repro_torch import configs, convert, random as tr
from repro_torch.configs import get_config
from repro_torch.configs.base import LM_SHAPES
from repro_torch.models import Model
from repro_torch.models.params import leaves

from _torch_families_common import (CPU, NEW_ARCHS,  # noqa: F401
                                    _one_thread, cfgs, f32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_all_configs_match_reference():
    """The registry, the aliases and every config, field by field."""
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs._ALIASES == jconfigs._ALIASES
    got, want = configs.all_configs(), jconfigs.all_configs()
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == \
            dataclasses.asdict(want[name]), name
        assert dataclasses.asdict(got[name].smoke()) == \
            dataclasses.asdict(want[name].smoke()), name


@pytest.mark.parametrize("alias", sorted(jconfigs._ALIASES))
def test_get_config_aliases(alias):
    assert get_config(alias).name == jget_config(alias).name


def test_unknown_family_raises_value_error():
    """As in the reference: a family the stacks do not know raises
    ``ValueError`` where it is used."""
    cfg = get_config("tinyllama-1.1b").smoke().replace(family="conv")
    m = Model(cfg, CPU)
    with pytest.raises(ValueError, match="conv"):
        m.param_defs()
    with pytest.raises(ValueError, match="conv"):
        m.init_cache(1, 8)
    params = Model(get_config("tinyllama-1.1b").smoke(), CPU).init_params(
        tr.PRNGKey(0))
    with pytest.raises(ValueError, match="conv"):
        m.forward(params, {"tokens": torch.zeros(1, 4, dtype=torch.int32)})


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_specs_match_reference(arch):
    """``input_specs`` of every LM shape, ``cache_abstract`` and
    ``cache_dims``: the reference's shapes and dtypes (by name)."""
    jm, m = JModel(jget_config(arch)), Model(get_config(arch), CPU)
    for jshape, shape in zip(JLM_SHAPES, LM_SHAPES):
        want = jm.input_specs(jshape)
        got = m.input_specs(shape)
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (k, shape.name)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    want = jm.cache_abstract(3, 40)
    got = m.cache_abstract(3, 40)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    assert m.cache_dims() == jm.cache_dims()


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_match_reference(arch, scan_layers):
    """Same key, same weights, leaf by leaf in jax's tree order; both tree
    forms (with ``scan_layers=False`` the layers, and the MoE's experts,
    are lists)."""
    jcfg, cfg = cfgs(arch, scan_layers=scan_layers)
    jp = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    port = Model(cfg, CPU)
    params = port.init_params(tr.PRNGKey(0))
    want = jax.tree.leaves(jp)
    got = leaves(params.tree())
    assert len(got) == len(want) == len(leaves(port.param_defs()))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_allclose(f32(g), f32(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_lm_params_numpy_round_trip(arch, dtype):
    """numpy → port → numpy gives the JAX package's tree back, bit for
    bit, in both tree forms; float32 leaves (RWKV's ``w0``/``u``,
    Mamba's ``A_log``...) stay float32 in a bf16 model."""
    for scan in (True, False):
        jcfg, cfg = cfgs(arch, dtype, scan_layers=scan)
        tree = jax.tree.map(np.asarray,
                            JModel(jcfg).init_params(jax.random.PRNGKey(3)))
        params = convert.lm_params_from_numpy(tree, cfg, CPU)
        back = convert.lm_params_to_numpy(params)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(g, w.astype(np.float32))
        for g, w in zip(leaves(params.tree()), jax.tree.leaves(tree)):
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
